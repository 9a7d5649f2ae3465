// K7: decode attention over one layer's segment of the int4 POOL cache,
// with the bf16 append tail folded in.
//
// Replaces kvzip_tpu/ops/pool_decode.py::pool_decode_attend_int4
// (_pool_int4_kernel), with its opt-in int8 dots (q8). The layer's kept rows
// sit at pool rows [layer_off[l], layer_off[l] + layer_rows[l]), split-packed
// int4 (P, D/2) with one float32 (scale, zero) per row; a row is visible to
// the queries of kv head h iff row_head == h (-1 marks padding). Tail row j
// of head h (bf16) is visible to query i iff j < tail_len[h] + i + 1 (one
// length for every head, or one per kv head, as the merged pool of serving
// passes).
//
// Bound on the H100: device-memory bytes (the layer's kept rows and tail).
// Design: K3's flash-decoding (splits of CH pool rows plus one split for the
// tail, one CTA per (split, kv head, group of 64 packed rows), a merge
// kernel) and its per-tile row_head skip, so each tile of a head-major pool
// is read by one head's CTAs only. The body is int4_decode.cuh's, shared
// with K11: exact pool tiles go through the int4 loader (keys folded in
// float32, values dequantized to bf16), q8 tiles through s8 mma.sync on the
// raw bytes (p quantized per 64-row tile aligned to layer_off); the tail
// stays bf16 and takes K3's path in both modes.
#include "int4_decode.cuh"

using namespace kvz;

template <bool Q8>
__global__ void pool_int4_partial_kernel(
    const bf16* __restrict__ q, const uint8_t* __restrict__ k_pool, const float* __restrict__ k_s,
    const float* __restrict__ k_z, const uint8_t* __restrict__ v_pool,
    const float* __restrict__ v_s, const float* __restrict__ v_z,
    const int* __restrict__ row_head, const int* __restrict__ layer_off,
    const int* __restrict__ layer_rows, const bf16* __restrict__ k_tail,
    const bf16* __restrict__ v_tail, const int* __restrict__ tail_lens, float* part_acc,
    float* part_ml, int T, int H, int Hkv, int G,
    int Tcap, int layer, int tail_len, int CH, int S_pool, float scale) {
  const int split = blockIdx.x, hk = blockIdx.y;
  const bool is_tail = split == S_pool;
  const int off = layer_off[layer];
  const size_t t_off = (static_cast<size_t>(layer) * Hkv + hk) * Tcap * D;
  const int k0 = is_tail ? 0 : split * CH;
  const int tl = tail_lens ? tail_lens[hk] : tail_len;
  const int k1 = is_tail ? min(tl + T, Tcap) : min(k0 + CH, layer_rows[layer]);
  int4_decode_partial<Q8>(q, H, G, T, k_pool + static_cast<size_t>(off) * DP, k_s + off, k_z + off,
                          v_pool + static_cast<size_t>(off) * DP, v_s + off, v_z + off,
                          row_head + off, k0, k1, is_tail, k_tail + t_off, v_tail + t_off,
                          tl, part_acc, part_ml, split, S_pool + 1, scale);
}

// q (T, H, D) bf16; k_pool/v_pool (P, D/2) uint8; k_s/k_z/v_s/v_z (P,) f32;
// row_head (P,) int32; layer_off/layer_rows (L,) int32; k_tail/v_tail
// (L, Hkv, Tcap, D) bf16; tail_lens (Hkv,) int32 or null for the one
// tail_len; out (T, H, D); part_acc (Hkv, S_pool + 1, G*T, D)
// and part_ml (Hkv, S_pool + 1, G*T, 2) f32 scratch; q8: the int8-attention
// mode.
extern "C" int kvz_pool_decode_int4(const void* q, const void* k_pool, const void* k_s,
                                    const void* k_z, const void* v_pool, const void* v_s,
                                    const void* v_z, const void* row_head, const void* layer_off,
                                    const void* layer_rows, const void* k_tail,
                                    const void* v_tail, const void* tail_lens, void* out,
                                    void* part_acc, void* part_ml,
                                    int T, int H, int Hkv, int Tcap, int layer, int tail_len,
                                    int CH, int S_pool, int q8, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G = H / Hkv, R = G * T;
  dim3 grid(S_pool + 1, Hkv, (R + 63) / 64);
  auto kernel = q8 ? pool_int4_partial_kernel<true> : pool_int4_partial_kernel<false>;
  kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(k_pool),
      static_cast<const float*>(k_s), static_cast<const float*>(k_z),
      static_cast<const uint8_t*>(v_pool), static_cast<const float*>(v_s),
      static_cast<const float*>(v_z), static_cast<const int*>(row_head),
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
