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
// Bound on the H100: bytes (a few operations per element; bf16 in, int8 out).
// Design: the TPU kernel held a (rows, width) tile in VMEM; here one CTA per
// token row holds the row in registers, VPT <= 4 16-byte vectors (8
// elements) per thread, up to 1,024 threads (rows of up to 32,768
// elements), so the row is read from memory once. Two block reductions
// (sum of squares or nothing, then amax) through shared memory; products are written with __fmul_rn so the compiler fuses none
// of them into an FMA the plain version does not make.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    act_mul_quant_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                         int8_t* __restrict__ q, float* __restrict__ s, int F, int act) {
  __shared__ float red[32];
  const int row = blockIdx.x, nvec = F / VEC;
  const size_t base = static_cast<size_t>(row) * F;
  float h[VPT][VEC];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    int v = threadIdx.x + j * blockDim.x;
    if (v >= nvec) continue;
    float u[VEC];
    load8(gate + base + v * VEC, h[j]);
    load8(up + base + v * VEC, u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float g = h[j][e], a;
      if (act == 0) {  // silu: g * sigmoid(g)
        a = __fmul_rn(g, 1.f / (1.f + expf(-g)));
      } else {         // gelu, tanh approximation
        float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
        a = 0.5f * g * (1.f + tanhf(inner));
      }
      h[j][e] = __fmul_rn(a, u[e]);
      amax = fmaxf(amax, fabsf(h[j][e]));
    }
  }
  quantize_store<VPT>(h, nvec, amax, q + base, s + row, red);
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

// gate/up (T, F) bf16 -> q (T, F) int8, s (T,) f32; act 0 = silu, 1 = gelu
// (tanh); F % 8 == 0, F <= 32768.
extern "C" int kvz_silu_mul_quant(const void* gate, const void* up, void* q, void* s, int T,
                                  int F, int act, void* stream) {
  int vpt, nthr;
  if (F % VEC || !geometry(F, &vpt, &nthr)) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KVZ_LAUNCH(V)                                                                         \
  act_mul_quant_kernel<V><<<T, nthr, 0, st>>>(                                                \
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up), static_cast<int8_t*>(q), \
      static_cast<float*>(s), F, act)
  KVZ_DISPATCH_VPT(vpt, KVZ_LAUNCH)
#undef KVZ_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
