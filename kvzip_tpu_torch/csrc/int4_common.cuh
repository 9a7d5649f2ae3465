// Shared definitions of the int4 attention kernels (K5-K7, K11): the
// split-packed row layout.
//
// A packed row holds D / 2 bytes; byte j carries element j in its high
// nibble and element j + D / 2 in its low nibble, with one (scale, zero)
// per row: x = n * scale + zero (ops/quant.py).
//
// The kernels keep keys as nibbles and fold the quant algebra out of the
// q.k product in float32, as the TPU kernels do: q.x = scale * (q.n) +
// zero * sum(q) (K5/K6's prefill form centre the nibbles first). Values are
// dequantized once to bf16 (n * scale + zero, rounded once) or, in the
// prefill form, their scales folded into p.
#pragma once

#include "attn_common.cuh"

namespace kvz {

constexpr int DP = D / 2;  // packed bytes per row

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

}  // namespace kvz
