// Shared device code of the attention kernels (K1-K4, K10): bf16 mma.sync tiles
// with fp32 accumulation, cp.async tile loads and the fp32 online softmax.
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + nvalid) of a row-major (rows, D) bf16 matrix into a
// (BK, SROW) smem tile; rows past nvalid are zero-filled.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0, int nvalid,
                                          int tid, int nthr) {
  for (int i = tid; i < BK * (D / 8); i += nthr) {
    int r = i >> 4, c = (i & 15) * 8;
    bool ok = r < nvalid;
    const bf16* src = ok ? g + (static_cast<size_t>(row0) + r) * D + c : g;
    cp_async16(s + r * SROW + c, src, ok);
  }
}

// The A fragments of one warp's 16 query rows (lo = gid, hi = gid + 8),
// read straight from global memory; a null row pointer gives zeros.
__device__ __forceinline__ void load_q(uint32_t qa[KK_D][4], const bf16* lo, const bf16* hi,
                                       int tig) {
#pragma unroll
  for (int kk = 0; kk < KK_D; ++kk) {
    int c = kk * 16 + tig * 2;
    qa[kk][0] = lo ? ld32(lo + c) : 0u;
    qa[kk][1] = hi ? ld32(hi + c) : 0u;
    qa[kk][2] = lo ? ld32(lo + c + 8) : 0u;
    qa[kk][3] = hi ? ld32(hi + c + 8) : 0u;
  }
}

// s = q . k^T for the warp's 16 rows against the BK keys of the smem tile.
__device__ __forceinline__ void qk_tile(float s[NT_K][4], const uint32_t qa[KK_D][4],
                                        const bf16* Ks, int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* kr = Ks + (nt * 8 + gid) * SROW + tig * 2;
#pragma unroll
    for (int kk = 0; kk < KK_D; ++kk) mma16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
  }
}

// acc += bf16(p) . V for the BK keys of the smem tile.
__device__ __forceinline__ void pv_tile(float acc[NT_D][4], const float p[NT_K][4], const bf16* Vs,
                                        int gid, int tig) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4] = {pack_f32(p[2 * kk][0], p[2 * kk][1]), pack_f32(p[2 * kk][2], p[2 * kk][3]),
                     pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                     pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* v0 = Vs + (kk * 16 + tig * 2) * SROW + gid;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) {
      const bf16* v = v0 + nt * 8;
      mma16816(acc[nt], a, pack_raw(v[0], v[SROW]), pack_raw(v[8 * SROW], v[9 * SROW]));
    }
  }
}

// Running (max, denominator, numerator) of one warp's two rows per lane.
struct Online {
  float m[2];
  float l[2];
  float acc[NT_D][4];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  // One online-softmax step over masked scores s (-inf = masked); s is
  // overwritten with the probabilities. Keeps the reference's guards: a row
  // that has seen no key keeps m = -inf, l = 0 and acc = 0.
  __device__ __forceinline__ void update(float s[NT_K][4], const bf16* Vs, int gid, int tig) {
    float alpha[2];
    probs(s, alpha);
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    pv_tile(acc, s, Vs, gid, tig);
  }

  // The softmax half of update(): m and l advance, s becomes the
  // probabilities, and alpha receives the factor by which the caller
  // rescales acc before adding this tile's values.
  __device__ __forceinline__ void probs(float s[NT_K][4], float alpha[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float mn[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = m[i] != -INFINITY ? expf(m[i] - mn[i]) : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = s[nt][j];
        float p = v != -INFINITY ? expf(v - mn[j >> 1]) : 0.f;
        s[nt][j] = p;
        rs[j >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
      m[i] = mn[i];
    }
  }
};

// Flash-decoding partials: layout part_acc (Hkv, S, R, D), part_ml (Hkv, S, R, 2).
__device__ __forceinline__ void write_partial(const Online& st, float* part_acc, float* part_ml,
                                              int hk, int split, int S, int R, int r_lo, int gid,
                                              int tig, bool with_acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int r = r_lo + 8 * i;
    if (r >= R) continue;
    size_t row = (static_cast<size_t>(hk) * S + split) * R + r;
    if (tig == 0) {
      part_ml[row * 2] = st.m[i];
      part_ml[row * 2 + 1] = st.l[i];
    }
    if (!with_acc) continue;
    float* o = part_acc + row * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt)
      *reinterpret_cast<float2*>(o + nt * 8) = make_float2(st.acc[nt][2 * i], st.acc[nt][2 * i + 1]);
  }
}

// Merge of the flash-decoding partials (K10's second launch; the other
// decode kernels merge inside their own launch): one block of D threads per
// (packed row r, kv head). Row r of kv head hk is query qi = r % T of head
// hk * G + r / T; out is (T, H, D) bf16.
__global__ void merge_partials_kernel(const float* part_acc, const float* part_ml, bf16* out,
                                      int T, int H, int G, int S, int R) {
  int r = blockIdx.x, hk = blockIdx.y, d = threadIdx.x;
  const float* ml = part_ml + (static_cast<size_t>(hk) * S * R + r) * 2;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, ml[static_cast<size_t>(s) * R * 2]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    float m = ml[static_cast<size_t>(s) * R * 2];
    if (m == -INFINITY) continue;
    float w = expf(m - M);
    L += ml[static_cast<size_t>(s) * R * 2 + 1] * w;
    acc += part_acc[((static_cast<size_t>(hk) * S + s) * R + r) * D + d] * w;
  }
  int g = r / T, qi = r % T;
  out[(static_cast<size_t>(qi) * H + hk * G + g) * D + d] = __float2bfloat16_rn(acc / fmaxf(L, 1e-37f));
}

}  // namespace kvz
