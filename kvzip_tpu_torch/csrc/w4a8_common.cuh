// The W4A8 linears K15/K16 (w4a8_v1.cu): the per-token s8 quantization of
// the activations (ops/quant.py::quantize_act_int8), the byte transposition
// of four rows and the main kernel's loop over input groups (w4a8_groups),
// which takes the storage's scales through a functor. K8 (w4a8.cu) shared
// them until its Hopper redesign (tensor cores, one launch at T <= 4) and
// uses none of them now.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int GROUP = 128;
constexpr int NTHR = 128;        // threads of the main kernels
constexpr int COLS = NTHR * 4;   // byte columns per CTA
constexpr int PF = 8;            // row quads loaded ahead of their use

// One CTA per token: the row's largest |x|, then x / scale rounded to s8.
// Loads are 8 bf16 (16 bytes) a thread.
__global__ void act_quant_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                                 float* __restrict__ xs, int IN) {
  __shared__ float red[32];
  const int t = blockIdx.x, tid = threadIdx.x, nv = IN / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(t) * IN);
  float m = 0.f;
  for (int i = tid; i < nv; i += blockDim.x) {
    uint4 v = xr[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < (blockDim.x >> 5) ? red[tid] : 0.f;
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) red[0] = m;
  }
  __syncthreads();
  const float s = red[0] / 127.0f + 1e-8f;
  if (tid == 0) xs[t] = s;
  uint2* qr = reinterpret_cast<uint2*>(xq + static_cast<size_t>(t) * IN);
  for (int i = tid; i < nv; i += blockDim.x) {
    uint4 v = xr[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    int8_t q[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      q[2 * j] = static_cast<int8_t>(fminf(fmaxf(rintf(f.x / s), -127.f), 127.f));
      q[2 * j + 1] = static_cast<int8_t>(fminf(fmaxf(rintf(f.y / s), -127.f), 127.f));
    }
    qr[i] = *reinterpret_cast<const uint2*>(q);
  }
}

// Four rows' 32-bit words (4 byte columns each) -> four words, word c
// holding column c of the four rows (row 0 in the low byte).
__device__ __forceinline__ void byte_transpose(const uint32_t r[4], uint32_t col[4]) {
  uint32_t a = __byte_perm(r[0], r[1], 0x5140);
  uint32_t b = __byte_perm(r[2], r[3], 0x5140);
  uint32_t e = __byte_perm(r[0], r[1], 0x7362);
  uint32_t f = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(a, b, 0x5410);
  col[1] = __byte_perm(a, b, 0x7632);
  col[2] = __byte_perm(e, f, 0x5410);
  col[3] = __byte_perm(e, f, 0x7632);
}

// The main kernels' work for one CTA: tokens t0 .. t0 + TT - 1 (rows past T
// read as zero) against byte columns j0 .. j0 + 3 (this thread's) over the
// input groups g0 .. g1 - 1 of the bytes w (IN, OUT/2) of one layer,
// accumulated into f_hi (output columns j0 + c) and f_lo (half + j0 + c).
// Per group: warp t stages token t0 + t's 128 s8 activations and their sum
// in shared memory; each thread loads PF row quads ahead of their use,
// byte-transposes them so each word holds 4 input rows of one column,
// unpacks the nibbles with two masks (undoing the stored XOR 0x80) and
// multiplies them with the activations by dp4a, exact in int32 within the
// group; then scales(g, c, s_hi, z_hi, s_lo, z_lo) gives the group's
// un-primed float32 scale and zero of both output columns of byte column
// j0 + c, and f += a * s + sum(x) * z. A functor reads its scales with
// __ldg: the __restrict__ of a struct member does not reach the compiler,
// and with plain loads K15's T = 1 kernel ran measurably slower. Every thread of the CTA calls it
// (it synchronises); col_ok is false for threads past the last column.
template <int TT, class Scales>
__device__ __forceinline__ void w4a8_groups(const int8_t* __restrict__ xq,
                                            const uint8_t* __restrict__ w, const Scales& scales,
                                            int T, int IN, int half, int g0, int g1, int t0,
                                            int j0, bool col_ok, float (&f_hi)[TT][4],
                                            float (&f_lo)[TT][4]) {
  __shared__ int xw[TT][GROUP / 4];
  __shared__ int xsum[TT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) f_hi[t][c] = f_lo[t][c] = 0.f;

  for (int g = g0; g < g1; ++g) {
    __syncthreads();
    if (warp < TT) {  // warp t stages token t0 + t's 128 activations
      int t = t0 + warp;
      int v = t < T ? *reinterpret_cast<const int*>(xq + static_cast<size_t>(t) * IN +
                                                    g * GROUP + lane * 4)
                    : 0;
      xw[warp][lane] = v;
      int sm = __dp4a(v, 0x01010101, 0);
      for (int o = 16; o; o >>= 1) sm += __shfl_xor_sync(0xffffffffu, sm, o);
      if (lane == 0) xsum[warp] = sm;
    }
    __syncthreads();
    if (!col_ok) continue;
    int a_hi[TT][4], a_lo[TT][4];
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) a_hi[t][c] = a_lo[t][c] = 0;
    const uint8_t* wg = w + static_cast<size_t>(g) * GROUP * half + j0;
    // PF row quads (4 PF rows) are loaded before any of them is used
    for (int k0 = 0; k0 < GROUP / 4; k0 += PF) {
      uint32_t r[PF][4];
#pragma unroll
      for (int i = 0; i < PF; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[i][j] = __ldg(reinterpret_cast<const uint32_t*>(
              wg + static_cast<size_t>(4 * (k0 + i) + j) * half));
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        // byte-transpose: word c holds column j0 + c of the quad's 4 rows
        uint32_t col[4];
        byte_transpose(r[i], col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t u = col[c] ^ 0x80808080u;  // undo the stored bias
          int hi = static_cast<int>((u >> 4) & 0x0F0F0F0Fu);
          int lo = static_cast<int>(u & 0x0F0F0F0Fu);
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            int xv = xw[t][k0 + i];
            a_hi[t][c] = __dp4a(xv, hi, a_hi[t][c]);
            a_lo[t][c] = __dp4a(xv, lo, a_lo[t][c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s_hi, z_hi, s_lo, z_lo;
      scales(g, c, s_hi, z_hi, s_lo, z_lo);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        float xsm = static_cast<float>(xsum[t]);
        f_hi[t][c] += static_cast<float>(a_hi[t][c]) * s_hi + xsm * z_hi;
        f_lo[t][c] += static_cast<float>(a_lo[t][c]) * s_lo + xsm * z_lo;
      }
    }
  }
}

}  // namespace
