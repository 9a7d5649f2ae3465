// K7: decode attention over one layer's segment of the int4 POOL cache,
// with the bf16 append tail folded in.
//
// Replaces kvzip_tpu/ops/pool_decode.py::pool_decode_attend_int4
// (_pool_int4_kernel, without its opt-in int8 dots). The layer's kept rows
// sit at pool rows [layer_off[l], layer_off[l] + layer_rows[l]), split-packed
// int4 (P, D/2) with one float32 (scale, zero) per row; a row is visible to
// the queries of kv head h iff row_head == h (-1 marks padding). Tail row j
// of head h (bf16) is visible to query i iff j < tail_len + i + 1.
//
// Bound on the H100: device-memory bytes (the layer's kept rows and tail).
// Design: K3's flash-decoding (splits of CH pool rows plus one split for the
// tail, one CTA per (split, kv head, group of 64 packed rows), a merge
// kernel) and its per-tile row_head skip, so each tile of a head-major pool
// is read by one head's CTAs only. Pool tiles go through the int4 loader
// (int4_common.cuh: keys folded in float32, values dequantized to bf16);
// the tail stays bf16 and takes K3's path.
#include "int4_common.cuh"

using namespace kvz;

__global__ void pool_int4_partial_kernel(
    const bf16* __restrict__ q, const uint8_t* __restrict__ k_pool, const float* __restrict__ k_s,
    const float* __restrict__ k_z, const uint8_t* __restrict__ v_pool,
    const float* __restrict__ v_s, const float* __restrict__ v_z,
    const int* __restrict__ row_head, const int* __restrict__ layer_off,
    const int* __restrict__ layer_rows, const bf16* __restrict__ k_tail,
    const bf16* __restrict__ v_tail, float* part_acc, float* part_ml, int T, int H, int Hkv, int G,
    int Tcap, int layer, int tail_len, int CH, int S_pool, float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ __align__(16) bf16 Vs[BK * SROW];
  __shared__ float ksc[BK], kzc[BK];
  __shared__ int rh[BK];
  const int split = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int R = G * T;
  const int r_lo = blockIdx.z * 64 + warp * 16 + gid, r_hi = r_lo + 8;
  const bool active = blockIdx.z * 64 + warp * 16 < R;
  const int qi_lo = r_lo % T, qi_hi = r_hi % T;
  const bool is_tail = split == S_pool;

  uint32_t qa[KK_D][4];
  load_q(qa, r_lo < R ? q + (static_cast<size_t>(qi_lo) * H + hk * G + r_lo / T) * D : nullptr,
         r_hi < R ? q + (static_cast<size_t>(qi_hi) * H + hk * G + r_hi / T) * D : nullptr, tig);
  float qs[2];
  q_row_sums(qa, qs);

  int k0, k1, off = 0;
  const bf16 *kt = nullptr, *vt = nullptr;
  if (is_tail) {
    size_t o = (static_cast<size_t>(layer) * Hkv + hk) * Tcap * D;
    kt = k_tail + o;
    vt = v_tail + o;
    k0 = 0;
    k1 = min(tail_len + T, Tcap);
  } else {
    off = layer_off[layer];
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
        int id = tid < n ? row_head[off + c0 + tid] : -1;
        rh[tid] = id;
        mine = id == hk;
      }
      if (!__syncthreads_or(mine)) continue;  // no row of this kv head in the tile
      load_tile_int4<false>(Ks, ksc, kzc, k_pool, DP, k_s, k_z, 1, off + c0, n, tid, nthr);
      load_tile_int4<true>(Vs, nullptr, nullptr, v_pool, DP, v_s, v_z, 1, off + c0, n, tid, nthr);
    } else {
      load_tile(Ks, kt, c0, n, tid, nthr);
      load_tile(Vs, vt, c0, n, tid, nthr);
      cp_async_wait_all();
    }
    any_tile = true;
    __syncthreads();
    if (!active) continue;
    float s[NT_K][4];
    qk_tile(s, qa, Ks, gid, tig);
    if (!is_tail) fold_scores(s, qs, ksc, kzc, tig, scale);
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int cl = nt * 8 + tig * 2 + (j & 1);
        bool ok;
        if (is_tail)
          ok = c0 + cl < tail_len + ((j >> 1) ? qi_hi : qi_lo) + 1 && cl < n;
        else
          ok = rh[cl] == hk;
        s[nt][j] = ok ? (is_tail ? s[nt][j] * scale : s[nt][j]) : -INFINITY;
      }
    }
    st.update(s, Vs, gid, tig);
  }
  if (active) write_partial(st, part_acc, part_ml, hk, split, S_pool + 1, R, r_lo, gid, tig, any_tile);
}

// q (T, H, D) bf16; k_pool/v_pool (P, D/2) uint8; k_s/k_z/v_s/v_z (P,) f32;
// row_head (P,) int32; layer_off/layer_rows (L,) int32; k_tail/v_tail
// (L, Hkv, Tcap, D) bf16; out (T, H, D); part_acc (Hkv, S_pool + 1, G*T, D)
// and part_ml (Hkv, S_pool + 1, G*T, 2) f32 scratch.
extern "C" int kvz_pool_decode_int4(const void* q, const void* k_pool, const void* k_s,
                                    const void* k_z, const void* v_pool, const void* v_s,
                                    const void* v_z, const void* row_head, const void* layer_off,
                                    const void* layer_rows, const void* k_tail,
                                    const void* v_tail, void* out, void* part_acc, void* part_ml,
                                    int T, int H, int Hkv, int Tcap, int layer, int tail_len,
                                    int CH, int S_pool, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G = H / Hkv, R = G * T;
  dim3 grid(S_pool + 1, Hkv, (R + 63) / 64);
  pool_int4_partial_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(k_pool),
      static_cast<const float*>(k_s), static_cast<const float*>(k_z),
      static_cast<const uint8_t*>(v_pool), static_cast<const float*>(v_s),
      static_cast<const float*>(v_z), static_cast<const int*>(row_head),
      static_cast<const int*>(layer_off), static_cast<const int*>(layer_rows),
      static_cast<const bf16*>(k_tail), static_cast<const bf16*>(v_tail),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), T, H, Hkv, G, Tcap, layer,
      tail_len, CH, S_pool, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_partials_kernel<<<dim3(R, Hkv), D, 0, st>>>(static_cast<const float*>(part_acc),
                                                    static_cast<const float*>(part_ml),
                                                    static_cast<bf16*>(out), T, H, G, S_pool + 1,
                                                    R);
  return static_cast<int>(cudaGetLastError());
}
