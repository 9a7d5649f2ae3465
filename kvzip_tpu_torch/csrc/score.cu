// K2: KVzip reconstruction scores of one layer and one scoring chunk.
//
// Replaces kvzip_tpu/ops/score_kernel.py::fused_scores (_score_kernel).
// Keys are [sink | ctx window (s_ctx) | repeat (T)]. Logits are rounded to
// bf16 before a full softmax over all keys; only the repeat block is causal;
// ctx columns past ctx_len are masked; padded queries (>= q_valid) are zeroed
// after the softmax; the score is the max over (group, query) of the ctx
// columns' probabilities. No probability tensor reaches device memory.
//
// Bound on the H100: tensor-core operations (two q . k products per key).
// Design: the TPU kernel kept one running-max output block across a
// sequential grid; here CTAs run in any order. One CTA per (kv head, block of
// BQ queries), the GQA group packed as G * BQ rows (one warp per 16 rows).
// Pass 1 streams every key tile for the rows' max and denominator; pass 2
// streams the ctx tiles again, forms the probabilities, reduces the column
// max over the CTA's rows in shared memory and folds it into `out` with
// atomicMax on the float bits, which is exact and order-independent because
// the probabilities are >= 0 and `out` starts at zero.
#include "attn_common.cuh"

using namespace kvz;

__device__ __forceinline__ float masked_logit(float s, int col, int t, int sink, int s0,
                                              int ctx_len, int K) {
  bool bad = (col >= s0 && col - s0 > t) || (col >= sink + ctx_len && col < s0) || col >= K;
  return bad ? -INFINITY : __bfloat162float(__float2bfloat16_rn(s));
}

__global__ void score_kernel(const bf16* __restrict__ q, const bf16* __restrict__ keys,
                             float* __restrict__ out, int T, int H, int K, int G, int wph,
                             int sink, int s_ctx, int ctx_len, int q_valid, float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ unsigned colmax[BK];
  const int hk = blockIdx.x, qb = blockIdx.y;
  const int BQ = 16 * wph;
  if (qb * BQ >= q_valid) return;  // every row of this block is padding
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int g = warp / wph, sub = warp % wph;
  const int head = hk * G + g;
  const int t_lo = qb * BQ + sub * 16 + gid, t_hi = t_lo + 8;
  const int s0 = sink + s_ctx;

  uint32_t qa[KK_D][4];
  load_q(qa, t_lo < T ? q + (static_cast<size_t>(t_lo) * H + head) * D : nullptr,
         t_hi < T ? q + (static_cast<size_t>(t_hi) * H + head) * D : nullptr, tig);
  const bf16* kh = keys + static_cast<size_t>(hk) * K * D;

  // pass 1: row max and denominator over all K keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < K; c0 += BK) {
    __syncthreads();
    load_tile(Ks, kh, c0, min(BK, K - c0), tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    float s[NT_K][4];
    qk_tile(s, qa, Ks, gid, tig);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int col = c0 + nt * 8 + tig * 2 + (j & 1);
        s[nt][j] = masked_logit(s[nt][j] * scale, col, (j >> 1) ? t_hi : t_lo, sink, s0,
                                ctx_len, K);
        mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
      }
    }
    float mn[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) mn[i] = fmaxf(m[i], quad_max(mx[i]));
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rs[j >> 1] += s[nt][j] != -INFINITY ? expf(s[nt][j] - mn[j >> 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float alpha = m[i] != -INFINITY ? expf(m[i] - mn[i]) : 0.f;
      l[i] = l[i] * alpha + quad_sum(rs[i]);
      m[i] = mn[i];
    }
  }

  // pass 2: probabilities of the ctx columns, column max into out
  const bool live[2] = {t_lo < q_valid && t_lo < T, t_hi < q_valid && t_hi < T};
  for (int c0 = sink; c0 < s0; c0 += BK) {
    const int ncols = min(BK, s0 - c0);
    __syncthreads();
    load_tile(Ks, kh, c0, ncols, tid, nthr);
    if (tid < BK) colmax[tid] = 0u;
    cp_async_wait_all();
    __syncthreads();
    float s[NT_K][4];
    qk_tile(s, qa, Ks, gid, tig);
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int col = c0 + nt * 8 + tig * 2 + (j & 1);
        int i = j >> 1;
        float x = masked_logit(s[nt][j] * scale, col, i ? t_hi : t_lo, sink, s0, ctx_len, K);
        float p = x != -INFINITY ? expf(x - m[i]) / fmaxf(l[i], 1e-37f) : 0.f;
        s[nt][j] = (live[i] && col < s0) ? p : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float cm = fmaxf(s[nt][j], s[nt][j + 2]);
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 4));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 8));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
        if (gid == 0 && cm > 0.f) atomicMax(&colmax[nt * 8 + tig * 2 + j], __float_as_uint(cm));
      }
    }
    __syncthreads();
    for (int i = tid; i < ncols; i += nthr) {
      unsigned x = colmax[i];
      if (x) atomicMax(reinterpret_cast<unsigned*>(out) + static_cast<size_t>(hk) * s_ctx + (c0 - sink) + i, x);
    }
  }
}

// q (T, H, D) bf16; keys (Hkv, K, D) bf16; out (Hkv, s_ctx) f32 (zeroed here).
extern "C" int kvz_fused_scores(const void* q, const void* keys, void* out, int T, int H,
                                int Hkv, int K, int sink, int s_ctx, int ctx_len, int q_valid,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * Hkv * s_ctx, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int G = H / Hkv;
  int wph = G >= 8 ? 1 : 8 / G;
  dim3 grid(Hkv, (T + 16 * wph - 1) / (16 * wph));
  score_kernel<<<grid, 32 * G * wph, 0, st>>>(static_cast<const bf16*>(q),
                                              static_cast<const bf16*>(keys),
                                              static_cast<float*>(out), T, H, K, G, wph, sink,
                                              s_ctx, ctx_len, q_valid, scale);
  return static_cast<int>(cudaGetLastError());
}
