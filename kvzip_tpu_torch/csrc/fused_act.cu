// K13 and K14: fused activation quantization of the W8A8 path.
//
// Replaces kvzip_tpu/ops/fused_act.py::rmsnorm_quant (K13,
// _rmsnorm_quant_kernel) and ::silu_mul_quant (K14, _silu_mul_quant_kernel):
// QServe's RMSNormGeneral and SiluAndMulQuant. Per token row, in float32
// throughout: h = rms_norm(x) * w (K13; (1 + w) under gemma) or
// h = act(gate) * up (K14), then s = amax(|h|) / 127 + 1e-8 and
// q = clamp(rint(h / s), -127, 127) (round half to even, IEEE division, as
// the plain version's torch.round(h / s)).
//
// Bound on the H100: bytes (bf16 in, int8 out), with about 25 instructions
// an element for K14 (its exp and reciprocal, the quotient), as long as the
// bytes at full rate.
//
// K13: the TPU kernel held a (rows, width) tile in VMEM; here one CTA per
// token row holds the row in registers, VPT <= 4 16-byte vectors (8
// elements) per thread, up to 1,024 threads (rows of up to 32,768
// elements), so the row is read from memory once. Two block reductions
// (sum of squares, then amax) through shared memory; products are written
// with __fmul_rn so the compiler fuses none of them into an FMA the plain
// version does not make.
//
// K14 has two forms, chosen by ops/fused_act.py::plan:
// - cluster form (decode and short chunks, T < 100 on the H100): a row
//   split over a cluster of C = 4, 8 or 16 CTAs on neighbouring SMs, each
//   holding its slice in registers; each warp pushes its maximum into
//   every CTA's shared memory (st.async on the receiver's mbarrier), so a
//   T = 1 row streams on C SMs instead of one and no remote read waits
//   behind a barrier (reading the maxima after a cluster barrier instead
//   took 0.0036 ms at T 1, against 0.0028);
// - row form (prefill and scoring chunks): one CTA a row of 512 threads,
//   its gate and up rows staged in shared memory by two TMA bulk copies
//   (4F bytes; three CTAs an SM at F 14,336, so one CTA's loads overlap
//   the others' arithmetic), h written over them in place, then quantized
//   from there.
// The cluster form is a programmatic dependent launch (0.4-0.5 us off a
// T = 1 call). Both take h / s as div_rn(h, s, 1 / s) (one correctly rounded
// reciprocal a row: the IEEE quotient) and the sigmoid's 1 / (1 + e^-g) as
// __frcp_rn (the IEEE reciprocal); expf and tanhf stay the accurate ones.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int VEC = 8;         // elements per 16-byte load
constexpr int MAX_THREADS = 1024;
constexpr int MAX_VPT = 4;     // 1,024 threads of VPT = 8 would need > 64 registers each

__device__ __forceinline__ void load8(const bf16* p, float f[VEC]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Sum (or max) of v over the block; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();  // red is reused by the next reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  return v;
}

// Per-token scale from the threads' partial amax, then the int8 row.
template <int VPT>
__device__ __forceinline__ void quantize_store(const float (&h)[VPT][VEC], int nvec, float amax,
                                               int8_t* qrow, float* srow, float* red) {
  const float s = block_reduce<true>(amax, red) / 127.f + 1e-8f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    int v = threadIdx.x + j * blockDim.x;
    if (v >= nvec) continue;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      int qi = static_cast<int>(fminf(fmaxf(rintf(h[j][e] / s), -127.f), 127.f));
      w[e >> 2] |= (static_cast<uint32_t>(qi) & 0xffu) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(qrow + static_cast<size_t>(v) * VEC) = make_uint2(w[0], w[1]);
  }
  if (threadIdx.x == 0) *srow = s;
}

template <int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         int8_t* __restrict__ q, float* __restrict__ s, int D, float eps,
                         int gemma) {
  __shared__ float red[32];
  const int row = blockIdx.x, nvec = D / VEC;
  const bf16* xr = x + static_cast<size_t>(row) * D;
  float h[VPT][VEC];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    int v = threadIdx.x + j * blockDim.x;
    if (v >= nvec) continue;
    load8(xr + v * VEC, h[j]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += __fmul_rn(h[j][e], h[j][e]);
  }
  const float r = rsqrtf(block_reduce<false>(ss, red) / static_cast<float>(D) + eps);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    int v = threadIdx.x + j * blockDim.x;
    if (v >= nvec) continue;
    float wf[VEC];
    load8(w + v * VEC, wf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float wv = gemma ? 1.f + wf[e] : wf[e];
      h[j][e] = __fmul_rn(__fmul_rn(h[j][e], r), wv);
      amax = fmaxf(amax, fabsf(h[j][e]));
    }
  }
  quantize_store<VPT>(h, nvec, amax, q + static_cast<size_t>(row) * D, s + row, red);
}

// ---------------------------------------------------------------- K14
constexpr int CL_THREADS = 256;  // threads a CTA of the cluster form, at most
constexpr int CL_VPT = 4;        // vectors a thread of the cluster form, at most
constexpr int CL_MAX = 16;       // CTAs a cluster (above 8 non-portable)
constexpr int RF_THREADS = 512;  // threads a CTA of the row form
constexpr int RF_MAX_WIDTH = 32768;

// Eight bf16 (a 16-byte vector) to float32, exactly.
__device__ __forceinline__ void unpack8(uint4 u, float f[VEC]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// h = act(g) * u as the plain version rounds it: silu g * (1 / (1 + e^-g)),
// gelu in its tanh form.
__device__ __forceinline__ void act_mul8(uint4 gv, uint4 uv, int act, float h[VEC]) {
  float g[VEC], u[VEC];
  unpack8(gv, g);
  unpack8(uv, u);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float a;
    if (act == 0) {
      a = __fmul_rn(g[e], __frcp_rn(__fadd_rn(1.f, expf(-g[e]))));
    } else {
      float inner = 0.7978845608028654f * (g[e] + 0.044715f * g[e] * g[e] * g[e]);
      a = 0.5f * g[e] * (1.f + tanhf(inner));
    }
    h[e] = __fmul_rn(a, u[e]);
  }
}

__device__ __forceinline__ float amax8(const float h[VEC], float m) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(h[e]));
  return m;
}

// Four int8 of clamp(rint(h / s)) packed in a word; r = 1 / s correctly
// rounded. Clamping before rounding gives the same integers (the bounds
// are integers).
__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float s, float r) {
  const float x[4] = {a, b, c, d};
  int q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q[e] = __float2int_rn(fminf(fmaxf(sm90::div_rn(x[e], s, r), -127.f), 127.f));
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// Cluster form: grid (C, T), cluster (C, 1, 1); CTA c of row blockIdx.y
// takes vectors [c * per, min(nvec, (c + 1) * per)), thread t its
// vectors c * per + t + j * blockDim.x (j < VPT). Each warp pushes its
// maximum into every CTA of the cluster (st.async into slot c * warps +
// warp, counted on the receiver's mbarrier), so a CTA has all C * warps
// maxima, and the row's amax, once its own mbarrier completes: no remote
// read waits behind a barrier. A cluster barrier arrived at the start and
// waited before the pushes makes every CTA's mbarrier initialised first;
// a second one, arrived after the pushes and waited at the end, keeps
// every CTA until the pushes into it are done. A programmatic dependent
// launch: the CTAs may be scheduled while the kernel before ends; nothing
// it wrote is read, and nothing is written, before it has completed.
template <int VPT>
__global__ void __launch_bounds__(CL_THREADS)
    act_quant_cluster_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                             int8_t* __restrict__ q, float* __restrict__ s, int F, int per,
                             int act) {
  constexpr int SLOTS = CL_MAX * (CL_THREADS / 32);
  __shared__ float wmax[SLOTS];
  __shared__ uint64_t bar;
  const int c = blockIdx.x, C = gridDim.x, row = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, nw = blockDim.x >> 5;
  const int v0 = c * per, v1 = min(F / VEC, v0 + per);
  const size_t base = static_cast<size_t>(row) * F;
  const uint4* g4 = reinterpret_cast<const uint4*>(gate + base);
  const uint4* u4 = reinterpret_cast<const uint4*>(up + base);
  if (tid == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::mbar_expect_tx(&bar, 4u * C * nw);
    sm90::fence_barrier_init();
  }
  sm90::cluster_arrive();  // waited for before the first push: every barrier initialised
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  uint4 gv[VPT], uv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = v0 + tid + j * blockDim.x;
    if (v < v1) {
      gv[j] = g4[v];
      uv[j] = u4[v];
    }
  }
  float h[VPT][VEC];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (v0 + tid + j * blockDim.x >= v1) continue;
    act_mul8(gv[j], uv[j], act, h[j]);
    m = amax8(h[j], m);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  sm90::cluster_wait();
  if (lane < C) sm90::st_async_cluster(&wmax[c * nw + (tid >> 5)], m, &bar, lane);
  sm90::cluster_arrive();  // this CTA's pushes are issued
  sm90::mbar_wait(&bar, 0);
  float rv[SLOTS / 32];
#pragma unroll
  for (int k = 0; k < SLOTS / 32; ++k) rv[k] = lane + 32 * k < C * nw ? wmax[lane + 32 * k] : 0.f;
  m = 0.f;
#pragma unroll
  for (int k = 0; k < SLOTS / 32; ++k) m = fmaxf(m, rv[k]);
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float sc = m / 127.f + 1e-8f, r = __frcp_rn(sc);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = v0 + tid + j * blockDim.x;
    if (v >= v1) continue;
    *reinterpret_cast<uint2*>(q + base + static_cast<size_t>(v) * VEC) =
        make_uint2(quant4(h[j][0], h[j][1], h[j][2], h[j][3], sc, r),
                   quant4(h[j][4], h[j][5], h[j][6], h[j][7], sc, r));
  }
  if (c == 0 && tid == 0) s[row] = sc;
  sm90::cluster_wait();
}

// Row form: one CTA a row. Thread 0 copies the gate and up rows into
// shared memory (two bulk copies on one mbarrier); each thread turns its
// vectors v = tid + k * RF_THREADS into h in place (h[0:4] over the gate
// vector, h[4:8] over the up vector: the bytes it alone read), then, after
// the block's amax, quantizes them from there.
__global__ void __launch_bounds__(RF_THREADS, 3)
    act_quant_rows_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                          int8_t* __restrict__ q, float* __restrict__ s, int F, int act) {
  extern __shared__ __align__(128) uint8_t rowbuf[];  // gate row, then up row (2F bytes each)
  __shared__ uint64_t bar;
  __shared__ float red[32];
  const int row = blockIdx.x, tid = threadIdx.x, nvec = F / VEC;
  const size_t base = static_cast<size_t>(row) * F;
  uint4* gs = reinterpret_cast<uint4*>(rowbuf);
  uint4* us = reinterpret_cast<uint4*>(rowbuf + 2 * F);
  if (tid == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar, 4u * F);
    sm90::bulk_load(gs, gate + base, 2u * F, &bar);
    sm90::bulk_load(us, up + base, 2u * F, &bar);
  }
  sm90::mbar_wait(&bar, 0);
  float m = 0.f;
  for (int v = tid; v < nvec; v += RF_THREADS) {
    float h[VEC];
    act_mul8(gs[v], us[v], act, h);
    m = amax8(h, m);
    gs[v] = make_uint4(__float_as_uint(h[0]), __float_as_uint(h[1]), __float_as_uint(h[2]),
                       __float_as_uint(h[3]));
    us[v] = make_uint4(__float_as_uint(h[4]), __float_as_uint(h[5]), __float_as_uint(h[6]),
                       __float_as_uint(h[7]));
  }
  const float sc = block_reduce<true>(m, red) / 127.f + 1e-8f, r = __frcp_rn(sc);
  for (int v = tid; v < nvec; v += RF_THREADS) {
    const float4 a = reinterpret_cast<const float4*>(gs)[v];
    const float4 b = reinterpret_cast<const float4*>(us)[v];
    *reinterpret_cast<uint2*>(q + base + static_cast<size_t>(v) * VEC) =
        make_uint2(quant4(a.x, a.y, a.z, a.w, sc, r), quant4(b.x, b.y, b.z, b.w, sc, r));
  }
  if (tid == 0) s[row] = sc;
}

// Vectors per thread and threads per CTA for a row of `width` elements;
// false if the row is wider than the kernels take.
bool geometry(int width, int* vpt, int* nthr) {
  int nvec = width / VEC;
  *vpt = 1;
  while (*vpt * MAX_THREADS < nvec) *vpt *= 2;
  *nthr = ((nvec + *vpt - 1) / *vpt + 31) / 32 * 32;
  return *vpt <= MAX_VPT;
}

template <int VPT>
int launch_cluster(const bf16* gate, const bf16* up, int8_t* q, float* s, int T, int F, int C,
                   int nthr, int per, int act, cudaStream_t st) {
  static bool wide[64] = {};  // per device: clusters above 8 CTAs allowed
  int dev = 0;
  cudaGetDevice(&dev);
  if (C > 8 && dev < 64 && !wide[dev]) {
    cudaError_t e = cudaFuncSetAttribute(act_quant_cluster_kernel<VPT>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    wide[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, T);
  cfg.blockDim = dim3(nthr);
  cfg.stream = st;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, act_quant_cluster_kernel<VPT>, gate, up, q, s, F, per, act));
}

}  // namespace

#define KVZ_DISPATCH_VPT(vpt, launch) \
  switch (vpt) {                      \
    case 1: launch(1); break;         \
    case 2: launch(2); break;         \
    default: launch(4); break;        \
  }

// x (T, D) bf16, w (D,) bf16 -> q (T, D) int8, s (T,) f32; D % 8 == 0,
// D <= 32768.
extern "C" int kvz_rmsnorm_quant(const void* x, const void* w, void* q, void* s, int T, int D,
                                 float eps, int gemma, void* stream) {
  int vpt, nthr;
  if (D % VEC || !geometry(D, &vpt, &nthr)) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KVZ_LAUNCH(V)                                                                      \
  rmsnorm_quant_kernel<V><<<T, nthr, 0, st>>>(                                             \
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<int8_t*>(q), \
      static_cast<float*>(s), D, eps, gemma)
  KVZ_DISPATCH_VPT(vpt, KVZ_LAUNCH)
#undef KVZ_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// gate/up (T, F) bf16, 16-byte aligned -> q (T, F) int8, s (T,) f32; act 0
// = silu, 1 = gelu (tanh); F % 8 == 0, F <= 32768. The plan
// (ops/fused_act.py::plan): C CTAs a row in the cluster form (4, 8 or 16)
// with nthr threads each, or C = 0 for the row form.
extern "C" int kvz_silu_mul_quant(const void* gate, const void* up, void* q, void* s, int T,
                                  int F, int act, int C, int nthr, void* stream) {
  if (F % VEC || F <= 0 || F > RF_MAX_WIDTH) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* g = static_cast<const bf16*>(gate);
  const bf16* u = static_cast<const bf16*>(up);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(s);
  if (C == 0) {
    static bool attr[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 64 && !attr[dev]) {
      cudaError_t e = cudaFuncSetAttribute(act_quant_rows_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           4 * RF_MAX_WIDTH);
      if (e != cudaSuccess) return static_cast<int>(e);
      attr[dev] = true;
    }
    act_quant_rows_kernel<<<T, RF_THREADS, 4 * F, st>>>(g, u, qo, so, F, act);
    return static_cast<int>(cudaGetLastError());
  }
  const int nvec = F / VEC, per = (nvec + C - 1) / C;
  if ((C != 4 && C != 8 && C != CL_MAX) || nthr % 32 || nthr < 32 ||
      nthr > CL_THREADS || per > nthr * CL_VPT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpt = (per + nthr - 1) / nthr;
  if (vpt == 1) return launch_cluster<1>(g, u, qo, so, T, F, C, nthr, per, act, st);
  if (vpt == 2) return launch_cluster<2>(g, u, qo, so, T, F, C, nthr, per, act, st);
  return launch_cluster<4>(g, u, qo, so, T, F, C, nthr, per, act, st);
}
