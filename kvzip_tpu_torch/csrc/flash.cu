// K1: causal GQA flash attention of T queries against the dense cache.
//
// Replaces kvzip_tpu/ops/flash.py::flash_attend (_flash_kernel). Key j of
// kv head h is visible to query i iff j < base_lens[h] + i + 1; fp32 online
// softmax; rows that see no key give 0.
//
// Bound on the H100: tensor-core operations at prefill and scoring shapes
// (T in the thousands against a cache of the same order).
// Design: one CTA per (kv head, block of BQ queries); the GQA group is packed
// into the CTA as G * BQ rows, one warp per 16 (query, head) rows, so each
// K/V tile is read from memory once for the whole group and reused by every
// warp out of shared memory. q . k and p . v run as bf16 mma.sync with fp32
// accumulation; the softmax stays in registers. Key tiles past the last key
// the block's final query can see are never loaded.
#include "attn_common.cuh"

using namespace kvz;

__global__ void flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ base_lens,
                             bf16* __restrict__ out, int T, int H, int C, int G, int wph,
                             float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ __align__(16) bf16 Vs[BK * SROW];
  const int hk = blockIdx.x, qb = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int BQ = 16 * wph;
  const int g = warp / wph, sub = warp % wph;
  const int head = hk * G + g;
  const int t_lo = qb * BQ + sub * 16 + gid, t_hi = t_lo + 8;

  uint32_t qa[KK_D][4];
  load_q(qa, t_lo < T ? q + (static_cast<size_t>(t_lo) * H + head) * D : nullptr,
         t_hi < T ? q + (static_cast<size_t>(t_hi) * H + head) * D : nullptr, tig);

  Online st;
  st.init();
  const int base = base_lens[hk];
  const int q_end = min(qb * BQ + BQ, T);
  const int kv_end = min(base + q_end, C);
  const bf16* kh = k + static_cast<size_t>(hk) * C * D;
  const bf16* vh = v + static_cast<size_t>(hk) * C * D;

  for (int c0 = 0; c0 < kv_end; c0 += BK) {
    __syncthreads();
    int n = min(BK, kv_end - c0);
    load_tile(Ks, kh, c0, n, tid, nthr);
    load_tile(Vs, vh, c0, n, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    float s[NT_K][4];
    qk_tile(s, qa, Ks, gid, tig);
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int col = c0 + nt * 8 + tig * 2 + (j & 1);
        int t = (j >> 1) ? t_hi : t_lo;
        bool ok = col < base + t + 1 && col < kv_end;
        s[nt][j] = ok ? s[nt][j] * scale : -INFINITY;
      }
    }
    st.update(s, Vs, gid, tig);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int t = i ? t_hi : t_lo;
    if (t >= T) continue;
    float den = fmaxf(st.l[i], 1e-37f);
    bf16* o = out + (static_cast<size_t>(t) * H + head) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
          __floats2bfloat162_rn(st.acc[nt][2 * i] / den, st.acc[nt][2 * i + 1] / den);
  }
}

// q (T, H, D), k/v (Hkv, C, D) bf16; base_lens (Hkv,) int32; out (T, H, D).
extern "C" int kvz_flash_attend(const void* q, const void* k, const void* v,
                                const void* base_lens, void* out, int T, int H, int Hkv, int C,
                                float scale, void* stream) {
  int G = H / Hkv;
  int wph = G >= 8 ? 1 : 8 / G;  // warps per query head: G * wph <= 8 warps
  dim3 grid(Hkv, (T + 16 * wph - 1) / (16 * wph));
  flash_kernel<<<grid, 32 * G * wph, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(base_lens), static_cast<bf16*>(out), T, H, C, G, wph, scale);
  return static_cast<int>(cudaGetLastError());
}
