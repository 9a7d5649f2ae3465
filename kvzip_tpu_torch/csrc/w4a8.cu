// K8: W4A8 linear over one layer of a stacked int4 weight (T < 512 rows).
//
// Replaces kvzip_tpu/ops/w4a8_v2.py::w4a8_matmul_stacked_v2
// (_w4a8_v2_kernel). Storage as in the reference's v2 layout: bytes
// (L, IN, OUT/2) split-packed along OUT (byte column j holds output column
// j in the high nibble and j + OUT/2 in the low nibble) and stored XOR 0x80;
// bf16 s2/z2 (L, 2, Gp8, OUT/2) per (nibble half, group of 128 input rows,
// byte column), the high half pre-folded as s_hi / 16 and z_hi + 8 s_hi.
// Activations round per token to s8 (ops/quant.py::quantize_act_int8).
//
// Bound on the H100: device-memory bytes at decode (T = 1 reads every
// weight byte for 2 operations per nibble); integer operations at the
// prefill ladder's T = 64-256.
// Design: a small kernel quantizes the activations (16-byte loads, one CTA
// per token); the main kernel gives each thread 4 byte columns (8 output
// columns) and loops over 128-row groups (w4a8_common.cuh::w4a8_groups,
// shared with K15/K16; this file gives it the v2 scales). Four rows' 32-bit
// words are byte-transposed (__byte_perm) so each word holds 4 consecutive
// input rows of one column; the nibbles are unpacked with two masks and
// multiplied with the s8 activations by dp4a, exactly in int32 within a
// group. Each thread loads 32 words ahead of their use, so that enough
// bytes are in flight to stream device memory. Per group the int32 sums
// are scaled in float32 with the un-primed scale and zero
// (dequantize_weight_int4_v2's expansion) and the group's activation sum.
// The input groups are split over CTAs so that a single token still fills
// the card; a last kernel sums the splits and applies the token scale.
#include "w4a8_common.cuh"

namespace {

// The v2 scales of byte column j0 + c, their high half un-primed:
// s_hi = 16 sh, z_hi = zh - 8 s_hi.
struct ScalesV2 {
  const bf16* s2;
  const bf16* z2;
  int half, Gp8, j0;
  __device__ __forceinline__ void operator()(int g, int c, float& s_hi, float& z_hi,
                                             float& s_lo, float& z_lo) const {
    const size_t o_hi = static_cast<size_t>(g) * half + j0 + c;
    const size_t o_lo = (static_cast<size_t>(Gp8) + g) * half + j0 + c;
    s_hi = __bfloat162float(__ldg(&s2[o_hi])) * 16.f;
    z_hi = __bfloat162float(__ldg(&z2[o_hi])) - 8.f * s_hi;
    s_lo = __bfloat162float(__ldg(&s2[o_lo]));
    z_lo = __bfloat162float(__ldg(&z2[o_lo]));
  }
};

template <int TT>
__global__ void __launch_bounds__(NTHR) w4a8_kernel(const int8_t* __restrict__ xq,
                                                    const uint8_t* __restrict__ w,
                                                    const bf16* __restrict__ s2,
                                                    const bf16* __restrict__ z2,
                                                    float* __restrict__ part, int T, int IN,
                                                    int half, int Gp8, int gps) {
  const int j0 = blockIdx.x * COLS + threadIdx.x * 4;
  const int split = blockIdx.y, t0 = blockIdx.z * TT;
  const int g0 = split * gps, g1 = min(g0 + gps, IN / GROUP);
  const bool col_ok = j0 < half;
  float f_hi[TT][4], f_lo[TT][4];
  w4a8_groups<TT>(xq, w, ScalesV2{s2, z2, half, Gp8, j0}, T, IN, half, g0, g1, t0, j0, col_ok,
                  f_hi, f_lo);
  if (!col_ok) return;
  const int OUT = 2 * half;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t0 + t >= T) continue;
    float* p = part + (static_cast<size_t>(split) * T + t0 + t) * OUT;
    *reinterpret_cast<float4*>(p + j0) = make_float4(f_hi[t][0], f_hi[t][1], f_hi[t][2], f_hi[t][3]);
    *reinterpret_cast<float4*>(p + half + j0) =
        make_float4(f_lo[t][0], f_lo[t][1], f_lo[t][2], f_lo[t][3]);
  }
}

__global__ void finish_kernel(const float* __restrict__ part, const float* __restrict__ xs,
                              bf16* __restrict__ out, int T, int OUT, int S) {
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  size_t n = static_cast<size_t>(T) * OUT;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[s * n + i];
  out[i] = __float2bfloat16_rn(acc * xs[i / OUT]);
}

}  // namespace

// x (T, IN) bf16; w (IN, OUT/2) uint8 and s2/z2 (2, Gp8, OUT/2) bf16, one
// layer's slices; out (T, OUT) bf16; scratch: xq (T, IN) int8, xs (T,) f32,
// part (S, T, OUT) f32 with S = ceil(IN / 128 / gps). tt is 1 or 4 (tokens
// per CTA).
extern "C" int kvz_w4a8(const void* x, const void* w, const void* s2, const void* z2, void* out,
                        void* xq, void* xs, void* part, int T, int IN, int OUT, int Gp8, int gps,
                        int tt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int aq = min(1024, (IN / 8 + 31) / 32 * 32);
  act_quant_kernel<<<T, aq, 0, st>>>(static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
                                     static_cast<float*>(xs), IN);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int half = OUT / 2, G = IN / GROUP, S = (G + gps - 1) / gps;
  dim3 grid((half + COLS - 1) / COLS, S, (T + tt - 1) / tt);
  if (tt == 1)
    w4a8_kernel<1><<<grid, NTHR, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(w),
        static_cast<const bf16*>(s2), static_cast<const bf16*>(z2), static_cast<float*>(part), T,
        IN, half, Gp8, gps);
  else if (tt == 4)
    w4a8_kernel<4><<<grid, NTHR, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(w),
        static_cast<const bf16*>(s2), static_cast<const bf16*>(z2), static_cast<float*>(part), T,
        IN, half, Gp8, gps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  size_t n = static_cast<size_t>(T) * OUT;
  finish_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(xs), static_cast<bf16*>(out), T,
      OUT, S);
  return static_cast<int>(cudaGetLastError());
}
