// K11: decode attention over one layer of the int4 FLAT cache, with the
// bf16 append tail folded in; exact or int8-attention (q8) mode.
//
// Replaces kvzip_tpu/ops/flat_decode.py::flat_decode_attend_int4
// (_flat_int4_kernel). Every layer holds the same R_seg rows per sequence
// (n_seq sequences, seq-major), split-packed int4 (L, n_seq * R_seg, D/2)
// with float32 (scale, zero) per row; query row r of sequence sb belongs
// to kv head (r / T) / G + sb * Hkv, and a flat row is visible to it iff
// its row_head equals that head (-1 marks padding). Tail row j of head h
// is visible to query i iff j < tail_len[h] + i + 1 (one length for every
// head, or one per (sequence, kv head)).
//
// Bound on the H100: device-memory bytes (the layer's live rows and tail).
// Design: the TPU kernel streamed every flat block through one sequential
// grid axis; here it is K7's flash-decoding (int4_decode.cuh): splits of
// CH rows of the sequence's segment plus one split for its tail, one CTA
// per (split, sequence and kv head, group of 64 packed rows), a merge
// kernel. The rows are head-major, so a CTA that finds no row of its head
// in a tile's row_head skips the tile: each tile is read by one head's
// CTAs, and padding by none, so bytes read stay near the live footprint.
// In q8 mode p is quantized per 64-row tile aligned to the segment's row 0.
#include "int4_decode.cuh"

using namespace kvz;

template <bool Q8>
__global__ void flat_int4_partial_kernel(
    const bf16* __restrict__ q, const uint8_t* __restrict__ kq, const float* __restrict__ ks,
    const float* __restrict__ kz, const uint8_t* __restrict__ vq, const float* __restrict__ vs,
    const float* __restrict__ vz, const int* __restrict__ row_head,
    const bf16* __restrict__ k_tail, const bf16* __restrict__ v_tail,
    const int* __restrict__ tail_lens, float* part_acc, float* part_ml, int T, int H_all,
    int Hkv, int n_seq, int Tcap, int layer, int R_seg, int tail_len, int CH, int S_seg,
    float scale) {
  const int split = blockIdx.x, hg = blockIdx.y;
  const int G = H_all / (n_seq * Hkv);
  const bool is_tail = split == S_seg;
  const size_t base = (static_cast<size_t>(layer) * n_seq + hg / Hkv) * R_seg;
  const size_t t_off = static_cast<size_t>(hg) * Tcap * D;
  const int tl = tail_lens ? tail_lens[hg] : tail_len;
  const int k0 = is_tail ? 0 : split * CH;
  const int k1 = is_tail ? min(tl + T, Tcap) : min(k0 + CH, R_seg);
  int4_decode_partial<Q8>(q, H_all, G, T, kq + base * DP, ks + base, kz + base, vq + base * DP,
                          vs + base, vz + base, row_head + base, k0, k1, is_tail,
                          k_tail + t_off, v_tail + t_off, tl, part_acc, part_ml, split,
                          S_seg + 1, scale);
}

// q (T, H_all, D) bf16 (H_all = n_seq * H); kq/vq (L, n_seq * R_seg, D/2)
// uint8; ks/kz/vs/vz and row_head (L, n_seq * R_seg) f32 / int32;
// k_tail/v_tail (n_seq * Hkv, Tcap, D) bf16, this layer's; tail_lens
// (n_seq * Hkv,) int32 or null for the one tail_len; out (T, H_all, D);
// part_acc (n_seq * Hkv, S_seg + 1, G*T, D) and part_ml (..., 2) f32
// scratch. Hkv is per sequence.
extern "C" int kvz_flat_decode_int4(const void* q, const void* kq, const void* ks,
                                    const void* kz, const void* vq, const void* vs,
                                    const void* vz, const void* row_head, const void* k_tail,
                                    const void* v_tail, const void* tail_lens, void* out,
                                    void* part_acc, void* part_ml, int T, int H_all, int Hkv,
                                    int n_seq, int Tcap, int layer, int R_seg, int tail_len,
                                    int CH, int S_seg, int q8, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G = H_all / (n_seq * Hkv), R = G * T;
  dim3 grid(S_seg + 1, n_seq * Hkv, (R + 63) / 64);
  auto kernel = q8 ? flat_int4_partial_kernel<true> : flat_int4_partial_kernel<false>;
  kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const float*>(kz),
      static_cast<const uint8_t*>(vq), static_cast<const float*>(vs),
      static_cast<const float*>(vz), static_cast<const int*>(row_head),
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
