// Shared definitions of the attention kernels (K1-K7, K9-K11): the head
// dim and tile constants, the bf16 mma.sync tile with fp32 accumulation,
// 16-byte cp.async loads and quad (4-lane) reductions.
//
// Fragment layouts follow PTX mma.m16n8k16 (row.col): a lane holds rows
// gid = lane / 4 and gid + 8 of a 16-row tile, and columns tig * 2 and
// tig * 2 + 1 (tig = lane % 4) of each 8-column tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kvz {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;         // head_dim every kernel is built for
constexpr int BK = 64;         // keys per shared-memory tile
constexpr int SROW = D + 8;    // padded smem row: fragment loads hit 32 distinct banks
constexpr int NT_K = BK / 8;   // 8-key score tiles per key tile
constexpr int NT_D = D / 8;    // 8-wide output tiles
constexpr int KK_D = D / 16;   // 16-deep steps of the q.k product

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace kvz
