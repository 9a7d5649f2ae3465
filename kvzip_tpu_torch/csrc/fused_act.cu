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
// K13: the TPU kernel held a (rows, width) tile in VMEM; here a grid sized
// to the card (ops/fused_act.py::plan_norm) takes the rows every grid-th.
// Each CTA keeps a few of its rows in flight (two by the plan), each row
// one TMA bulk copy into a ring of rows in shared memory on its own
// mbarrier, refilled as soon as a row's first reduction shows every
// thread has taken its vectors: no tail wave of short CTAs. A row's split
// over threads and its sum's tree are the first form's (one CTA a row: its
// thread t summed its vectors t, t + nthr, ... in order, then a warp
// butterfly and a block one), so the output is bit for bit that form's. A
// sum depends on its order, so the split stays; instead a thread stands
// for K (2 at one vector a thread; ops/fused_act.py::norm_vectors) of those
// threads, running their K warp butterflies side by side, which spreads a
// row's per-thread work over K times the elements and halves the CTA. The
// maximum, exact in any order, is one redux.sync a warp and one a block.
// Where K x VPT <= 2 a thread holds its weights as floats (1 + w applied
// once) and h from the maximum to the store. The sum and the maximum have
// shared slots of their own: a row takes two barriers, not four. Products
// are __fmul_rn, so the compiler fuses none into an FMA the plain version
// does not make; x / D, amax / 127 and h / s are div_rn with one correctly
// rounded reciprocal (a CTA's, a row's): the IEEE quotients; rint is an
// add of 1.5 * 2^23. A programmatic dependent launch: x and the weights
// are read only after griddepcontrol.wait. On the H100 at T 2,304:
// the first form 0.0182 ms, K 1 0.0177, K 2 0.0136, with the redux maximum
// and one clamp 0.0123 (tools/k13_variants.py).
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

// ---------------------------------------------------------------- K13
constexpr int NORM_MAX_STAGES = 4;  // rows a CTA keeps in flight, at most

// h = x * r * w (w + 1 under gemma) as the plain version rounds it.
__device__ __forceinline__ void norm8(uint4 xv, uint4 wv, float r, int gemma, float h[VEC]) {
  float xf[VEC], wf[VEC];
  unpack8(xv, xf);
  unpack8(wv, wf);
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    h[e] = __fmul_rn(__fmul_rn(xf[e], r), gemma ? 1.f + wf[e] : wf[e]);
}

// The first form's sum of one row: each of its threads' partial sum of
// squares butterflied over its warp, the warps' results in red, then
// butterflied over one warp again. Here a thread stands for K of that
// form's threads, p_k = (warp + k * nw) * 32 + lane (nw = blockDim.x /
// 32), so the K butterflies of a warp run side by side and give the first
// form's bits; nwp = K * nw is that form's warps. (Starting the second
// butterfly past its levels that add only zeros gave the same bits and
// ran 1 us slower at T 2,304: its loop over a count known at run time.)
template <int K>
__device__ __forceinline__ float row_sum(float (&v)[K], float* red, int nwp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp + k * nw] = v[k];
  __syncthreads();
  float t = lane < nwp ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// Four int8 of clamp(rint(h / s)) packed in a word; r = 1 / s correctly
// rounded. rint by adding 1.5 * 2^23 (round to nearest even puts the
// integer in the low mantissa bits), not by a conversion instruction. Only
// the lower bound is applied: |h| <= amax and s >= amax / 127 rounded, so
// h / s is within 127 * (1 + 2^-23) of zero and rounds into [-127, 127];
// fmaxf takes a NaN quotient to -127, as the first form's clamp did.
__device__ __forceinline__ uint32_t quant4_add(float a, float b, float c, float d, float s,
                                               float r) {
  const float x[4] = {a, b, c, d};
  uint32_t u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    u[e] = __float_as_uint(fmaxf(sm90::div_rn(x[e], s, r), -127.f) + 12582912.f);
  return __byte_perm(__byte_perm(u[0], u[1], 0x0040), __byte_perm(u[2], u[3], 0x0040), 0x5410);
}

// The row's maximum of the threads' partial maxima (each >= 0 and never a
// NaN: fmaxf drops NaNs), by redux.sync on their bits, which order as the
// floats do: a warp's in one instruction, then the warps'. A maximum is
// exact in any order, so this is the first form's value.
template <int K>
__device__ __forceinline__ float row_max(const float (&v)[K], float* red, int nwp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned m = __reduce_max_sync(0xffffffffu, __float_as_uint(v[k]));
    if (lane == 0) red[warp + k * nw] = __uint_as_float(m);
  }
  __syncthreads();
  const unsigned t = lane < nwp ? __float_as_uint(red[lane]) : 0u;
  return __uint_as_float(__reduce_max_sync(0xffffffffu, t));
}

// Rows every grid-th: CTA b takes rows b, b + gridDim.x, ...; its thread
// stands for K threads p of the first form (row_sum), each taking the
// vectors v = p + j * K * blockDim.x (j < VPT, v < D / 8). Thread 0 keeps
// `stages` of the CTA's rows in flight, one bulk copy a row into a ring of
// shared rows, each on its own mbarrier; a stage is refilled with the row
// `stages` rounds on once the first reduction's barrier shows every
// thread has taken its vectors from it. A thread's weights are loaded
// once, after griddepcontrol.wait (the kernel before may have written
// them) and while the first rows' copies fly: at K * VPT <= 2 as floats
// (1 + w under gemma) and h is held from the maximum to the store; above,
// packed, and h is made twice (the same products, the same bits). x / D and amax / 127 are div_rn with reciprocals made once a
// CTA (the IEEE quotients); 1 / s once a row.
template <int VPT, int K>
__global__ void __launch_bounds__(MAX_THREADS / K, (VPT == 1 && K == 1) ? 2 : K)
    rmsnorm_quant_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         int8_t* __restrict__ q, float* __restrict__ s, int T, int D, float eps,
                         int gemma, int stages) {
  constexpr bool HOLD = K * VPT <= 2;
  constexpr int KH = HOLD ? K : 1, VH = HOLD ? VPT : 1;
  extern __shared__ __align__(128) uint8_t ring[];  // stages rows of 2D bytes
  __shared__ uint64_t bar[NORM_MAX_STAGES];
  __shared__ float red_sum[32], red_max[32];
  const int tid = threadIdx.x, nthr = blockDim.x, nvec = D / VEC;
  const int warp = tid >> 5, lane = tid & 31, nw = nthr >> 5, nthr_p = K * nthr;
  const uint32_t row_bytes = 2u * D;
  const float fD = static_cast<float>(D), rD = __frcp_rn(fD), r127 = __frcp_rn(127.f);
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  uint4 wv[K][VPT], xv[K][VPT];
  float wf[KH][VH][VEC], h[KH][VH][VEC];
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      const int r = blockIdx.x + i * gridDim.x;
      if (r >= T) break;
      sm90::mbar_expect_tx(&bar[i], row_bytes);
      sm90::bulk_load(ring + i * row_bytes, x + static_cast<size_t>(r) * D, row_bytes, &bar[i]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = (warp + k * nw) * 32 + lane + j * nthr_p;
      wv[k][j] = v < nvec ? w4[v] : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (HOLD) {
        unpack8(wv[k][j], wf[k][j]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) wf[k][j][e] = gemma ? 1.f + wf[k][j][e] : wf[k][j][e];
      }
    }
  int n = 0;
  for (int row = blockIdx.x; row < T; row += gridDim.x, ++n) {
    const int stage = n % stages;
    sm90::mbar_wait(&bar[stage], (n / stages) & 1);
    const uint4* xs = reinterpret_cast<const uint4*>(ring + stage * row_bytes);
    float part[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      part[k] = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int v = (warp + k * nw) * 32 + lane + j * nthr_p;
        if (v >= nvec) continue;
        xv[k][j] = xs[v];
        float xf[VEC];
        unpack8(xv[k][j], xf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[k] += __fmul_rn(xf[e], xf[e]);
      }
    }
    const float r = rsqrtf(sm90::div_rn(row_sum<K>(part, red_sum, K * nw), fD, rD) +
                           eps);
    const int refill = row + stages * gridDim.x;
    if (tid == 0 && refill < T) {  // every thread has read this stage
      sm90::fence_proxy_async_shared();
      sm90::mbar_expect_tx(&bar[stage], row_bytes);
      sm90::bulk_load(ring + stage * row_bytes, x + static_cast<size_t>(refill) * D, row_bytes,
                      &bar[stage]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      part[k] = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if ((warp + k * nw) * 32 + lane + j * nthr_p >= nvec) continue;
        if constexpr (HOLD) {
          float xf[VEC];
          unpack8(xv[k][j], xf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) h[k][j][e] = __fmul_rn(__fmul_rn(xf[e], r), wf[k][j][e]);
          part[k] = amax8(h[k][j], part[k]);
        } else {
          float hh[VEC];
          norm8(xv[k][j], wv[k][j], r, gemma, hh);
          part[k] = amax8(hh, part[k]);
        }
      }
    }
    const float sc = sm90::div_rn(row_max<K>(part, red_max, K * nw), 127.f, r127) + 1e-8f;
    const float rc = __frcp_rn(sc);
    int8_t* qrow = q + static_cast<size_t>(row) * D;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int v = (warp + k * nw) * 32 + lane + j * nthr_p;
        if (v >= nvec) continue;
        float hh[VEC];
        if constexpr (HOLD) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) hh[e] = h[k][j][e];
        } else {
          norm8(xv[k][j], wv[k][j], r, gemma, hh);
        }
        *reinterpret_cast<uint2*>(qrow + static_cast<size_t>(v) * VEC) =
            make_uint2(quant4_add(hh[0], hh[1], hh[2], hh[3], sc, rc),
                       quant4_add(hh[4], hh[5], hh[6], hh[7], sc, rc));
      }
    if (tid == 0) s[row] = sc;
  }
}

template <int VPT, int K>
int launch_norm(const bf16* x, const bf16* w, int8_t* q, float* s, int T, int D, float eps,
                int gemma, int grid, int nthr, int stages, cudaStream_t st) {
  const int smem = stages * 2 * D;
  static int attr[64] = {};  // per device: the dynamic shared memory allowed so far
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && attr[dev] < smem) {
    cudaError_t e = cudaFuncSetAttribute(rmsnorm_quant_kernel<VPT, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(nthr);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, rmsnorm_quant_kernel<VPT, K>, x, w, q, s, T,
                                             D, eps, gemma, stages));
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

// x (T, D) bf16, w (D,) bf16, both 16-byte aligned -> q (T, D) int8, s (T,)
// f32; D % 8 == 0, D <= 32768. The plan (ops/fused_act.py::plan_norm):
// grid CTAs, each thread standing for K (1, 2 or 4; 1 above 8,192) of the
// nthr threads geometry() gives D, so nthr / K threads a CTA, each CTA
// keeping `stages` rows (1-4, 2D bytes each, at most 128 KB) in flight.
extern "C" int kvz_rmsnorm_quant(const void* x, const void* w, void* q, void* s, int T, int D,
                                 float eps, int gemma, int grid, int nthr, int K, int stages,
                                 void* stream) {
  int vpt, want;
  if (D % VEC || !geometry(D, &vpt, &want) || nthr != want || grid < 1 || stages < 1 ||
      stages > NORM_MAX_STAGES || stages * 2 * D > 128 * 1024 ||
      (K != 1 && (vpt != 1 || (K != 2 && K != 4))) || nthr % (32 * K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(s);
  const int n = nthr / K;
  if (K == 2) return launch_norm<1, 2>(xb, wb, qo, so, T, D, eps, gemma, grid, n, stages, st);
  if (K == 4) return launch_norm<1, 4>(xb, wb, qo, so, T, D, eps, gemma, grid, n, stages, st);
#define KVZ_LAUNCH(V) \
  return launch_norm<V, 1>(xb, wb, qo, so, T, D, eps, gemma, grid, n, stages, st)
  KVZ_DISPATCH_VPT(vpt, KVZ_LAUNCH)
#undef KVZ_LAUNCH
  return 0;
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
