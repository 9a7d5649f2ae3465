// K15/K16: W4A8 linear over the v1 storage, one layer of a stack (K15) or
// one unstacked weight with a bias (K16).
//
// Replaces kvzip_tpu/ops/w4a8.py::w4a8_matmul_stacked (_w4a8_stacked_kernel)
// and w4a8_matmul (_w4a8_kernel). v1 storage: bytes (L, INp, OUT/2) uint8
// split-packed along OUT (byte column j holds output column j in the high
// nibble and j + OUT/2 in the low nibble) and stored XOR 0x80; bf16 s, z
// (L, Gp, OUT) per (group of 128 input rows, output column), not pre-folded;
// INp = 128 Gp pads the input rows, and the pad groups carry s = z = 0.
// Activations round per token to s8 (ops/quant.py::quantize_act_int8).
//
//   out[t, j] = xs[t] * sum_g (s[g, j] * sum_{k in g} xq[t, k] n[k, j]
//                              + z[g, j] * sum_{k in g} xq[t, k])
//
// Bound on the H100: device-memory bytes at decode (T = 1 reads every
// weight byte for 2 operations per nibble); integer operations toward the
// 511 rows the dispatch sends here at most.
// Design: the group loop of w4a8_common.cuh::w4a8_groups (K8's before its
// Hopper redesign), with the v1 scales. A small kernel quantizes the
// activations; the main kernel gives each thread 4 byte columns (8 output
// columns) and loops over the true input groups only (G = IN / 128: the
// pad groups add exactly 0, so they are not read). Four rows' words are
// byte-transposed so each word holds 4 input rows of one column, the
// nibbles unpacked with two masks and multiplied with the s8 activations
// by dp4a, exact in int32 within a group; per group the sums are scaled in
// float32 by the column's own s and z (s[g, j] for the high nibble,
// s[g, j + OUT/2] for the low one). The input groups are split over CTAs so
// that one token fills the card, and the split shrinks as T grows (the
// token blocks fill it instead): with more than one split a last kernel
// adds the float32 partials in split order, so results never depend on
// timing; with one split the main kernel writes the output itself. The
// output is xs * sum cast to bf16, plus the bias (K16) added after that
// cast, as the reference adds it.
#include "w4a8_common.cuh"

namespace {

// The output value: xs * acc rounded to bf16, then the bias added and
// rounded again (bf16 + bf16 as PyTorch and JAX add them).
__device__ __forceinline__ bf16 finish(float v, const bf16* __restrict__ bias, int j) {
  bf16 y = __float2bfloat16_rn(v);
  if (bias != nullptr) y = __float2bfloat16_rn(__bfloat162float(y) + __bfloat162float(bias[j]));
  return y;
}

// The v1 scales of output columns j0 + c (high nibble) and half + j0 + c
// (low nibble), each column its own s and z.
struct ScalesV1 {
  const bf16* s;
  const bf16* z;
  int half, j0;
  __device__ __forceinline__ void operator()(int g, int c, float& s_hi, float& z_hi,
                                             float& s_lo, float& z_lo) const {
    const size_t o_hi = static_cast<size_t>(g) * 2 * half + j0 + c;
    const size_t o_lo = o_hi + half;
    s_hi = __bfloat162float(__ldg(&s[o_hi]));
    z_hi = __bfloat162float(__ldg(&z[o_hi]));
    s_lo = __bfloat162float(__ldg(&s[o_lo]));
    z_lo = __bfloat162float(__ldg(&z[o_lo]));
  }
};

template <int TT>
__global__ void __launch_bounds__(NTHR) w4a8_v1_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs, const uint8_t* __restrict__ w,
    const bf16* __restrict__ s, const bf16* __restrict__ z, const bf16* __restrict__ bias,
    float* __restrict__ part, bf16* __restrict__ out, int T, int IN, int half, int gps) {
  const int j0 = blockIdx.x * COLS + threadIdx.x * 4;
  const int split = blockIdx.y, t0 = blockIdx.z * TT;
  const int OUT = 2 * half;
  // the true input groups only: the pad groups add exactly 0
  const int g0 = split * gps, g1 = min(g0 + gps, IN / GROUP);
  const bool col_ok = j0 < half;
  float f_hi[TT][4], f_lo[TT][4];
  w4a8_groups<TT>(xq, w, ScalesV1{s, z, half, j0}, T, IN, half, g0, g1, t0, j0, col_ok, f_hi,
                  f_lo);
  if (!col_ok) return;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    const int tok = t0 + t;
    if (tok >= T) continue;
    if (part != nullptr) {
      float* p = part + (static_cast<size_t>(split) * T + tok) * OUT;
      *reinterpret_cast<float4*>(p + j0) =
          make_float4(f_hi[t][0], f_hi[t][1], f_hi[t][2], f_hi[t][3]);
      *reinterpret_cast<float4*>(p + half + j0) =
          make_float4(f_lo[t][0], f_lo[t][1], f_lo[t][2], f_lo[t][3]);
    } else {
      const float sc = xs[tok];
      bf16* o = out + static_cast<size_t>(tok) * OUT;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[j0 + c] = finish(f_hi[t][c] * sc, bias, j0 + c);
        o[half + j0 + c] = finish(f_lo[t][c] * sc, bias, half + j0 + c);
      }
    }
  }
}

__global__ void merge_kernel(const float* __restrict__ part, const float* __restrict__ xs,
                             const bf16* __restrict__ bias, bf16* __restrict__ out, int T,
                             int OUT, int S) {
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  size_t n = static_cast<size_t>(T) * OUT;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[s * n + i];
  out[i] = finish(acc * xs[i / OUT], bias, static_cast<int>(i % OUT));
}

}  // namespace

// x (T, IN) bf16; w (L, INp, OUT/2) uint8 and s/z (L, Gp, OUT) bf16, the
// whole stacks, of which layer `layer` is read (K16 passes L = 1, layer 0);
// bias (OUT,) bf16 or null; out (T, OUT) bf16; scratch: xq (T, IN) int8,
// xs (T,) f32 and, when S = ceil(IN / 128 / gps) > 1, part (S, T, OUT) f32
// (null for S = 1). tt is 1 or 4 (tokens per CTA).
extern "C" int kvz_w4a8_v1(const void* x, const void* w, const void* s, const void* z,
                           const void* bias, void* out, void* xq, void* xs, void* part, int T,
                           int IN, int INp, int OUT, int Gp, int layer, int gps, int tt,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int aq = min(1024, (IN / 8 + 31) / 32 * 32);
  act_quant_kernel<<<T, aq, 0, st>>>(static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
                                     static_cast<float*>(xs), IN);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int half = OUT / 2, G = IN / GROUP, S = (G + gps - 1) / gps;
  if ((S > 1) != (part != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* wl = static_cast<const uint8_t*>(w) + static_cast<size_t>(layer) * INp * half;
  const size_t so = static_cast<size_t>(layer) * Gp * OUT;
  const bf16* sl = static_cast<const bf16*>(s) + so;
  const bf16* zl = static_cast<const bf16*>(z) + so;
  const bf16* b = static_cast<const bf16*>(bias);
  dim3 grid((half + COLS - 1) / COLS, S, (T + tt - 1) / tt);
  if (tt == 1)
    w4a8_v1_kernel<1><<<grid, NTHR, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs), wl, sl, zl, b,
        static_cast<float*>(part), static_cast<bf16*>(out), T, IN, half, gps);
  else if (tt == 4)
    w4a8_v1_kernel<4><<<grid, NTHR, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs), wl, sl, zl, b,
        static_cast<float*>(part), static_cast<bf16*>(out), T, IN, half, gps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return static_cast<int>(e);
  size_t n = static_cast<size_t>(T) * OUT;
  merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(xs), b,
      static_cast<bf16*>(out), T, OUT, S);
  return static_cast<int>(cudaGetLastError());
}
