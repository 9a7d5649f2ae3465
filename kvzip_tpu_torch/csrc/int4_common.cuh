// Shared device code of the int4 attention kernels (K5-K7): loading
// split-packed int4 rows into the bf16 shared-memory tiles of
// attn_common.cuh.
//
// A packed row holds D / 2 bytes; byte j carries element j in its high
// nibble and element j + D / 2 in its low nibble, with one (scale, zero)
// per row: x = n * scale + zero (ops/quant.py).
//
// Keys: the tile holds the nibble values n as bf16 (exact), and the quant
// algebra is folded out of the q.k product in float32, as the TPU kernels
// do: q.x = scale * (q.n) + zero * sum(q). Values: the tile holds the
// dequantized n * scale + zero (float32, rounded once to bf16), so the
// p.v product is K1's; that one rounding is of the same size as rounding
// p to bf16, which the bf16 kernels already do.
#pragma once

#include "attn_common.cuh"

namespace kvz {

constexpr int DP = D / 2;  // packed bytes per row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Rows [row0, row0 + nvalid) of a packed matrix (row i at g + i * stride
// bytes, its scale and zero at gs/gz[i * sstride]) into a (BK, SROW) bf16
// tile: nibble values (DEQUANT false; the scales and zeros then go to
// sc/zc[BK]) or dequantized values (DEQUANT true). Rows past nvalid are
// zero, with scale and zero 0.
template <bool DEQUANT, typename S>
__device__ __forceinline__ void load_tile_int4(bf16* t, float* sc, float* zc, const uint8_t* g,
                                               size_t stride, const S* gs, const S* gz,
                                               size_t sstride, int row0, int nvalid, int tid,
                                               int nthr) {
  if (!DEQUANT) {
    for (int r = tid; r < BK; r += nthr) {
      bool ok = r < nvalid;
      size_t i = static_cast<size_t>(row0 + r) * sstride;
      sc[r] = ok ? to_f32(gs[i]) : 0.f;
      zc[r] = ok ? to_f32(gz[i]) : 0.f;
    }
  }
  for (int i = tid; i < BK * (DP / 16); i += nthr) {
    int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    float s = 0.f, z = 0.f;
    if (r < nvalid) {
      size_t row = static_cast<size_t>(row0 + r);
      w = *reinterpret_cast<const uint4*>(g + row * stride + c);
      if (DEQUANT) {
        s = to_f32(gs[row * sstride]);
        z = to_f32(gz[row * sstride]);
      }
    }
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&w);
    bf16* hi = t + r * SROW + c;
    bf16* lo = hi + DP;
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      float h0 = static_cast<float>(b[j] >> 4), h1 = static_cast<float>(b[j + 1] >> 4);
      float l0 = static_cast<float>(b[j] & 15), l1 = static_cast<float>(b[j + 1] & 15);
      if (DEQUANT) {
        h0 = h0 * s + z;
        h1 = h1 * s + z;
        l0 = l0 * s + z;
        l1 = l1 * s + z;
      }
      *reinterpret_cast<__nv_bfloat162*>(hi + j) = __floats2bfloat162_rn(h0, h1);
      *reinterpret_cast<__nv_bfloat162*>(lo + j) = __floats2bfloat162_rn(l0, l1);
    }
  }
}

// The float32 sums of the warp's two q rows (lo, hi) from their A
// fragments (each lane holds 32 of a row's 128 elements).
__device__ __forceinline__ void q_row_sums(const uint32_t qa[KK_D][4], float qs[2]) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int kk = 0; kk < KK_D; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][i]));
      float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][i + 1]));
      a += lo.x + lo.y;
      b += hi.x + hi.y;
    }
  }
  qs[0] = quad_sum(a);
  qs[1] = quad_sum(b);
}

// q.n -> (scale * q.n + zero * sum(q)) * softmax_scale on a tile of q.n
// products (qk_tile against a nibble tile).
__device__ __forceinline__ void fold_scores(float s[NT_K][4], const float qs[2], const float* sc,
                                            const float* zc, int tig, float scale) {
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int cl = nt * 8 + tig * 2 + (j & 1);
      s[nt][j] = (s[nt][j] * sc[cl] + qs[j >> 1] * zc[cl]) * scale;
    }
  }
}

}  // namespace kvz
