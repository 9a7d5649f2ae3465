// K10: decode attention over one layer of the bf16 FLAT cache, with the
// bf16 append tail folded in.
//
// Replaces kvzip_tpu/ops/flat_decode.py::flat_decode_attend (_flat_kernel).
// Every layer holds the same R_seg rows per sequence (n_seq sequences,
// seq-major), row-major (L, n_seq * R_seg, D) for K and V; query row r of
// sequence sb belongs to kv head (r / T) / G + sb * Hkv, and a flat row is
// visible to it iff its row_head equals that head (-1 marks padding). Tail
// row j of head h is visible to query i iff j < tail_len[h] + i + 1 (one
// length for every head, or one per (sequence, kv head)).
//
// Bound on the H100: device-memory bytes (the layer's live rows and tail).
// Design: the TPU kernel streamed every flat block through one sequential
// grid axis, which would leave most of the 132 SMs idle. This is K3's
// flash-decoding instead: splits of CH rows of the sequence's segment plus
// one split for its tail, one CTA per (split, sequence and kv head, group
// of 64 packed rows) writing a partial (m, l, acc), and K3's merge kernel.
// The rows are head-major, so a CTA reads a tile's row_head first and
// skips the tile when no row is its head's: each tile is read by one
// head's CTAs and padding by none, so bytes read stay near the live
// footprint (without the skip every head would read every row).
#include "attn_common.cuh"

using namespace kvz;

__global__ void flat_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_flat,
                                    const bf16* __restrict__ v_flat,
                                    const int* __restrict__ row_head,
                                    const bf16* __restrict__ k_tail,
                                    const bf16* __restrict__ v_tail,
                                    const int* __restrict__ tail_lens, float* part_acc,
                                    float* part_ml, int T, int H_all, int Hkv, int n_seq, int Tcap,
                                    int layer, int R_seg, int tail_len, int CH, int S_seg,
                                    float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ __align__(16) bf16 Vs[BK * SROW];
  __shared__ int rh[BK];
  const int split = blockIdx.x, hg = blockIdx.y;
  const int G = H_all / (n_seq * Hkv);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int R = G * T;
  const int r_lo = blockIdx.z * 64 + warp * 16 + gid, r_hi = r_lo + 8;
  const bool active = blockIdx.z * 64 + warp * 16 < R;
  const int qi_lo = r_lo % T, qi_hi = r_hi % T;
  const bool is_tail = split == S_seg;

  uint32_t qa[KK_D][4];
  load_q(qa, r_lo < R ? q + (static_cast<size_t>(qi_lo) * H_all + hg * G + r_lo / T) * D : nullptr,
         r_hi < R ? q + (static_cast<size_t>(qi_hi) * H_all + hg * G + r_hi / T) * D : nullptr,
         tig);

  const int tl = tail_lens ? tail_lens[hg] : tail_len;
  const bf16 *kh, *vh;
  const int* rhs = nullptr;
  int k0, k1;
  if (is_tail) {
    size_t off = static_cast<size_t>(hg) * Tcap * D;
    kh = k_tail + off;
    vh = v_tail + off;
    k0 = 0;
    k1 = min(tl + T, Tcap);
  } else {
    size_t base = (static_cast<size_t>(layer) * n_seq + hg / Hkv) * R_seg;
    kh = k_flat + base * D;
    vh = v_flat + base * D;
    rhs = row_head + base;
    k0 = split * CH;
    k1 = min(k0 + CH, R_seg);
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
        int id = tid < n ? rhs[c0 + tid] : -1;
        rh[tid] = id;
        mine = id == hg;
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
          ok = rh[cl] == hg;
        s[nt][j] = ok ? s[nt][j] * scale : -INFINITY;
      }
    }
    st.update(s, Vs, gid, tig);
  }
  if (active) write_partial(st, part_acc, part_ml, hg, split, S_seg + 1, R, r_lo, gid, tig, any_tile);
}

// q (T, H_all, D) bf16 (H_all = n_seq * H); k_flat/v_flat (L, n_seq * R_seg,
// D) bf16; row_head (L, n_seq * R_seg) int32; k_tail/v_tail
// (n_seq * Hkv, Tcap, D) bf16, this layer's; tail_lens (n_seq * Hkv,) int32
// or null for the one tail_len; out (T, H_all, D); part_acc
// (n_seq * Hkv, S_seg + 1, G*T, D) and part_ml (..., 2) f32 scratch. Hkv is
// per sequence.
extern "C" int kvz_flat_decode(const void* q, const void* k_flat, const void* v_flat,
                               const void* row_head, const void* k_tail, const void* v_tail,
                               const void* tail_lens, void* out, void* part_acc, void* part_ml,
                               int T, int H_all, int Hkv, int n_seq, int Tcap, int layer,
                               int R_seg, int tail_len, int CH, int S_seg, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G = H_all / (n_seq * Hkv), R = G * T;
  dim3 grid(S_seg + 1, n_seq * Hkv, (R + 63) / 64);
  flat_partial_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_flat),
      static_cast<const bf16*>(v_flat), static_cast<const int*>(row_head),
      static_cast<const bf16*>(k_tail), static_cast<const bf16*>(v_tail),
      static_cast<const int*>(tail_lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), T, H_all, Hkv, n_seq, Tcap, layer, R_seg, tail_len, CH,
      S_seg, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_partials_kernel<<<dim3(R, n_seq * Hkv), D, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), T, H_all, G, S_seg + 1, R);
  return static_cast<int>(cudaGetLastError());
}
