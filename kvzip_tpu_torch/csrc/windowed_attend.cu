// K9: attention output of the windowed scoring pass.
//
// Replaces kvzip_tpu/ops/windowed_attend.py::windowed_attend
// (_windowed_attend_kernel). The repeat-pass queries attend only
// keys = [sink | ctx window (s_ctx) | repeat (T)] of their kv head instead of
// the whole cache: causal on the trailing repeat block only (column
// c >= sink + s_ctx is visible to query t iff c - sink - s_ctx <= t), the
// padded window columns [sink + ctx_len, sink + s_ctx) dropped, padded query
// rows computed like any other (the engine discards them). fp32 softmax,
// bf16 output.
//
// Bound on the H100: tensor-core operations (T in the thousands against
// sink + s_ctx + T keys per kv head).
// Design: the TPU kernel held one kv head's whole key set (~4.5k rows, 1.1 MB
// each for K and V in bf16) in VMEM and took a one-shot softmax; that is far
// above the 227 KB of shared memory a CTA has, so this is K1's design over
// the concatenated keys, which the wrapper builds (the sink is not
// tile-aligned, so tiles run over the concatenation, not over three
// sources): one CTA per (kv head, block of queries), the GQA group packed as
// G * BQ rows, bf16 mma.sync with an fp32 online softmax over 64-key tiles.
// Tiles wholly inside the dropped window columns, and repeat tiles past the
// block's last query, are never loaded.
#include "attn_common.cuh"

using namespace kvz;

__global__ void windowed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ keys,
                                const bf16* __restrict__ vals, bf16* __restrict__ out, int T,
                                int H, int K, int G, int wph, int sink, int s_ctx, int ctx_len,
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
  const int s0 = sink + s_ctx, pad0 = sink + ctx_len;

  uint32_t qa[KK_D][4];
  load_q(qa, t_lo < T ? q + (static_cast<size_t>(t_lo) * H + head) * D : nullptr,
         t_hi < T ? q + (static_cast<size_t>(t_hi) * H + head) * D : nullptr, tig);

  Online st;
  st.init();
  const int q_end = min(qb * BQ + BQ, T);
  const int kv_end = min(s0 + q_end, K);
  const bf16* kh = keys + static_cast<size_t>(hk) * K * D;
  const bf16* vh = vals + static_cast<size_t>(hk) * K * D;

  for (int c0 = 0; c0 < kv_end; c0 += BK) {
    if (c0 >= pad0 && c0 + BK <= s0) continue;  // every column a dropped pad
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
        bool bad = col >= kv_end || (col >= s0 && col - s0 > t) || (col >= pad0 && col < s0);
        s[nt][j] = bad ? -INFINITY : s[nt][j] * scale;
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

// q (T, H, D); keys/vals (Hkv, K, D) bf16 with K = sink + s_ctx + T;
// out (T, H, D) bf16.
extern "C" int kvz_windowed_attend(const void* q, const void* keys, const void* vals, void* out,
                                   int T, int H, int Hkv, int K, int sink, int s_ctx,
                                   int ctx_len, float scale, void* stream) {
  int G = H / Hkv;
  int wph = G >= 8 ? 1 : 8 / G;  // warps per query head: G * wph <= 8 warps
  dim3 grid(Hkv, (T + 16 * wph - 1) / (16 * wph));
  windowed_kernel<<<grid, 32 * G * wph, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(keys),
      static_cast<const bf16*>(vals), static_cast<bf16*>(out), T, H, K, G, wph, sink, s_ctx,
      ctx_len, scale);
  return static_cast<int>(cudaGetLastError());
}
