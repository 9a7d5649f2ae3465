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
// per token); the main kernel gives
// each thread 4 byte columns (8 output columns) and loops over 128-row
// groups. Four rows' 32-bit words are byte-transposed (__byte_perm) so each
// word holds 4 consecutive input rows of one column; the nibbles are
// unpacked with two masks and multiplied with the s8 activations by dp4a,
// exactly in int32 within a group. Each thread loads 32 words ahead of
// their use, so that enough bytes are in flight to stream device memory.
// Per group the int32 sums are scaled in float32 with the un-primed scale
// and zero (dequantize_weight_int4_v2's expansion) and the group's
// activation sum. The input groups are split
// over CTAs so that a single token still fills the card; a last kernel sums
// the splits and applies the token scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int GROUP = 128;
constexpr int NTHR = 128;        // threads of the main kernel
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

template <int TT>
__global__ void __launch_bounds__(NTHR) w4a8_kernel(const int8_t* __restrict__ xq,
                                                    const uint8_t* __restrict__ w,
                                                    const bf16* __restrict__ s2,
                                                    const bf16* __restrict__ z2,
                                                    float* __restrict__ part, int T, int IN,
                                                    int half, int Gp8, int gps) {
  __shared__ int xw[TT][GROUP / 4];
  __shared__ int xsum[TT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * COLS + tid * 4;
  const int split = blockIdx.y, t0 = blockIdx.z * TT;
  const int G = IN / GROUP;
  const int g0 = split * gps, g1 = min(g0 + gps, G);
  const bool col_ok = j0 < half;

  float f_hi[TT][4], f_lo[TT][4];
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
        uint32_t a = __byte_perm(r[i][0], r[i][1], 0x5140);
        uint32_t b = __byte_perm(r[i][2], r[i][3], 0x5140);
        uint32_t e = __byte_perm(r[i][0], r[i][1], 0x7362);
        uint32_t f = __byte_perm(r[i][2], r[i][3], 0x7362);
        uint32_t col[4] = {__byte_perm(a, b, 0x5410), __byte_perm(a, b, 0x7632),
                           __byte_perm(e, f, 0x5410), __byte_perm(e, f, 0x7632)};
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
    // un-primed scale and zero of the group: s_hi = 16 sh, z_hi = zh - 8 s_hi
    const size_t o_hi = static_cast<size_t>(g) * half + j0;
    const size_t o_lo = (static_cast<size_t>(Gp8) + g) * half + j0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s_hi = __bfloat162float(s2[o_hi + c]) * 16.f;
      float z_hi = __bfloat162float(z2[o_hi + c]) - 8.f * s_hi;
      float s_lo = __bfloat162float(s2[o_lo + c]);
      float z_lo = __bfloat162float(z2[o_lo + c]);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        float xsm = static_cast<float>(xsum[t]);
        f_hi[t][c] += static_cast<float>(a_hi[t][c]) * s_hi + xsm * z_hi;
        f_lo[t][c] += static_cast<float>(a_lo[t][c]) * s_lo + xsm * z_lo;
      }
    }
  }
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
