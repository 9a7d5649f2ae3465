// K7: decode attention over one layer's segment of the int4 POOL cache,
// with the bf16 append tail folded in; exact or int8-attention (q8) mode.
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
// Design (int4_decode.cuh, shared with K11): one launch whose grid is sized
// to the card, every query row of the layer in each CTA (keys masked by
// row_head, so each byte is read once whatever the pool's order), 64-row
// tiles and 16-row tail tiles interleaved over the CTAs and streamed
// through a cp.async ring a key group, fragments built from the packed
// bytes (q8: a byte transpose in registers, no per-byte shared stores), and
// the merge of the splits' partials inside the launch once a release count
// is complete.
#include "int4_decode.cuh"

using namespace kvz;

// q (T, H, D) bf16; k_pool/v_pool (P, D/2) uint8; k_s/k_z/v_s/v_z (P,) f32;
// row_head (P,) int32; layer_off/layer_rows (L,) int32; k_tail/v_tail
// (L, Hkv, Tcap, D) bf16; tail_lens (Hkv,) int32 or null for the one
// tail_len; out (T, H, D); part_acc (rgs, S, 16 mtc, D) and part_ml
// (rgs, S, 16 mtc, 2) f32 scratch; tickets (rgs,) zero before the first
// launch (each launch leaves them zero); q8: the int8-attention mode.
extern "C" int kvz_pool_decode_int4(const void* q, const void* k_pool, const void* k_s,
                                    const void* k_z, const void* v_pool, const void* v_s,
                                    const void* v_z, const void* row_head, const void* layer_off,
                                    const void* layer_rows, const void* k_tail,
                                    const void* v_tail, const void* tail_lens, void* out,
                                    void* part_acc, void* part_ml, void* tickets, int T, int H,
                                    int Hkv, int Tcap, int layer, int tail_len, int S, int mtc,
                                    int rgs, int q8, float scale, void* stream) {
  i4d::Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.kq = static_cast<const uint8_t*>(k_pool);
  a.ks = static_cast<const float*>(k_s);
  a.kz = static_cast<const float*>(k_z);
  a.vq = static_cast<const uint8_t*>(v_pool);
  a.vs = static_cast<const float*>(v_s);
  a.vz = static_cast<const float*>(v_z);
  a.row_head = static_cast<const int*>(row_head);
  a.layer_off = static_cast<const int*>(layer_off);
  a.layer_rows = static_cast<const int*>(layer_rows);
  a.k_tail = static_cast<const bf16*>(k_tail);
  a.v_tail = static_cast<const bf16*>(v_tail);
  a.tail_lens = static_cast<const int*>(tail_lens);
  a.out = static_cast<bf16*>(out);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<unsigned*>(tickets);
  a.T = T;
  a.H_all = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.n_seq = 1;
  a.Tcap = Tcap;
  a.layer = layer;
  a.R_seg = 0;
  a.tail_len = tail_len;
  a.S = S;
  a.mtc = mtc;
  a.rgs = rgs;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return q8 ? i4d::launch<i4d::Q8>(a, st) : i4d::launch<i4d::EXACT>(a, st);
}
