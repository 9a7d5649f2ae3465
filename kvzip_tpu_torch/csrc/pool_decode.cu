// K3: decode attention over one layer's segment of the POOL cache, with the
// bf16 append tail folded in.
//
// Replaces kvzip_tpu/ops/pool_decode.py::pool_decode_attend
// (_pool_bf16_kernel). The layer's kept rows sit at pool rows
// [layer_off[l], layer_off[l] + layer_rows[l]); a row is visible to the
// queries of kv head h iff row_head == h (-1 marks padding). Tail row j of
// head h is visible to query i iff j < tail_len[h] + i + 1 (one length for
// every head, or one per kv head, as the merged pool of serving passes).
//
// Bound on the H100: device-memory bytes (the layer's kept rows and tail).
// Design: flash-decoding, as in K4. The segment is cut into splits of CH
// rows, plus one split for the tail; one CTA per (split, kv head, group of
// 64 packed rows) writes a partial (m, l, acc) and a small kernel merges
// the splits, tail included. The pool keeps K row-major (P, D), not the
// TPU's transposed (D, P). A CTA first reads the row_head ids of a tile and
// loads the tile's K/V only if a row belongs to its kv head: the pool is
// built head-major, so each tile's rows are read by one head's CTAs and the
// others skip it, and reads stay near the live footprint while the mask
// keeps any row order correct.
#include "attn_common.cuh"

using namespace kvz;

__global__ void pool_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                                    const bf16* __restrict__ v_pool,
                                    const int* __restrict__ row_head,
                                    const int* __restrict__ layer_off,
                                    const int* __restrict__ layer_rows,
                                    const bf16* __restrict__ k_tail,
                                    const bf16* __restrict__ v_tail,
                                    const int* __restrict__ tail_lens, float* part_acc,
                                    float* part_ml, int T, int H, int Hkv, int G, int Tcap,
                                    int layer, int tail_len, int CH, int S_pool, float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ __align__(16) bf16 Vs[BK * SROW];
  __shared__ int rh[BK];
  const int split = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int R = G * T;
  const int r_lo = blockIdx.z * 64 + warp * 16 + gid, r_hi = r_lo + 8;
  const bool active = blockIdx.z * 64 + warp * 16 < R;
  const int qi_lo = r_lo % T, qi_hi = r_hi % T;
  const bool is_tail = split == S_pool;
  const int tl = tail_lens ? tail_lens[hk] : tail_len;

  uint32_t qa[KK_D][4];
  load_q(qa, r_lo < R ? q + (static_cast<size_t>(qi_lo) * H + hk * G + r_lo / T) * D : nullptr,
         r_hi < R ? q + (static_cast<size_t>(qi_hi) * H + hk * G + r_hi / T) * D : nullptr, tig);

  const bf16 *kh, *vh;
  int k0, k1;
  const int* rhl = nullptr;
  if (is_tail) {
    size_t off = (static_cast<size_t>(layer) * Hkv + hk) * Tcap * D;
    kh = k_tail + off;
    vh = v_tail + off;
    k0 = 0;
    k1 = min(tl + T, Tcap);
  } else {
    int off = layer_off[layer];
    kh = k_pool + static_cast<size_t>(off) * D;
    vh = v_pool + static_cast<size_t>(off) * D;
    rhl = row_head + off;
    k0 = split * CH;
    k1 = min(k0 + CH, layer_rows[layer]);
  }

  Online st;
  st.init();
  bool any_tile = false;
  for (int c0 = k0; c0 < k1; c0 += BK) {
    int n = min(BK, k1 - c0);
    __syncthreads();
    if (!is_tail) {
      int mine = 0;
      if (tid < BK) {
        int id = tid < n ? rhl[c0 + tid] : -1;
        rh[tid] = id;
        mine = id == hk;
      }
      if (!__syncthreads_or(mine)) continue;  // no row of this kv head in the tile
    }
    any_tile = true;
    load_tile(Ks, kh, c0, n, tid, nthr);
    load_tile(Vs, vh, c0, n, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    float s[NT_K][4];
    qk_tile(s, qa, Ks, gid, tig);
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int cl = nt * 8 + tig * 2 + (j & 1);
        bool ok;
        if (is_tail)
          ok = c0 + cl < tl + ((j >> 1) ? qi_hi : qi_lo) + 1 && cl < n;
        else
          ok = rh[cl] == hk;
        s[nt][j] = ok ? s[nt][j] * scale : -INFINITY;
      }
    }
    st.update(s, Vs, gid, tig);
  }
  if (active) write_partial(st, part_acc, part_ml, hk, split, S_pool + 1, R, r_lo, gid, tig, any_tile);
}

// q (T, H, D) bf16; k_pool/v_pool (P, D) bf16; row_head (P,) int32;
// layer_off/layer_rows (L,) int32; k_tail/v_tail (L, Hkv, Tcap, D) bf16;
// tail_lens (Hkv,) int32 or null for the one tail_len; out (T, H, D);
// part_acc (Hkv, S_pool + 1, G*T, D) and part_ml (Hkv, S_pool + 1, G*T, 2)
// f32 scratch.
extern "C" int kvz_pool_decode(const void* q, const void* k_pool, const void* v_pool,
                               const void* row_head, const void* layer_off,
                               const void* layer_rows, const void* k_tail, const void* v_tail,
                               const void* tail_lens, void* out, void* part_acc,
                               void* part_ml, int T, int H, int Hkv, int Tcap, int layer,
                               int tail_len, int CH, int S_pool,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G = H / Hkv, R = G * T;
  dim3 grid(S_pool + 1, Hkv, (R + 63) / 64);
  pool_partial_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(row_head),
      static_cast<const int*>(layer_off), static_cast<const int*>(layer_rows),
      static_cast<const bf16*>(k_tail), static_cast<const bf16*>(v_tail),
      static_cast<const int*>(tail_lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), T, H, Hkv, G, Tcap, layer, tail_len, CH, S_pool, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_partials_kernel<<<dim3(R, Hkv), D, 0, st>>>(static_cast<const float*>(part_acc),
                                                    static_cast<const float*>(part_ml),
                                                    static_cast<bf16*>(out), T, H, G, S_pool + 1,
                                                    R);
  return static_cast<int>(cudaGetLastError());
}
