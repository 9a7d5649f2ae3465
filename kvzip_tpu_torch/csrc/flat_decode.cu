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
// grid axis; here it is K3's kernel, the BF16 mode of int4_decode.cuh (as
// K11 is K7's): every query row of a sequence in each CTA (keys masked by
// row_head), 32-row segment items and 16-row tail items interleaved over a
// grid sized to the card, a cp.async ring a key group, and the merge of the
// splits' partials inside the launch once a release count completes. The
// items stop at the segment's live rows (seg_rows), so no padding tile is
// read.
#include "int4_decode.cuh"

using namespace kvz;

// q (T, H_all, D) bf16 (H_all = n_seq * H); k_flat/v_flat (L, n_seq * R_seg,
// D) bf16; row_head (L, n_seq * R_seg) int32; seg_rows (L, n_seq) int32 live
// rows a segment (they come first), or null for R_seg; k_tail/v_tail
// (n_seq * Hkv, Tcap, D) bf16, this layer's; tail_lens (n_seq * Hkv,) int32
// or null for the one tail_len; out (T, H_all, D); part_acc (n_seq, rgs, S,
// 16 mtc, D) and part_ml (..., 2) f32 scratch; tickets (n_seq * rgs,) zero
// before the first launch (each launch leaves them zero). Hkv is per
// sequence.
extern "C" int kvz_flat_decode(const void* q, const void* k_flat, const void* v_flat,
                               const void* row_head, const void* seg_rows, const void* k_tail,
                               const void* v_tail, const void* tail_lens, void* out,
                               void* part_acc, void* part_ml, void* tickets, int T, int H_all,
                               int Hkv, int n_seq, int Tcap, int layer, int R_seg, int tail_len,
                               int S, int mtc, int rgs, float scale, void* stream) {
  i4d::Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.kb = static_cast<const bf16*>(k_flat);
  a.vb = static_cast<const bf16*>(v_flat);
  a.row_head = static_cast<const int*>(row_head);
  a.seg_rows = static_cast<const int*>(seg_rows);
  a.k_tail = static_cast<const bf16*>(k_tail);
  a.v_tail = static_cast<const bf16*>(v_tail);
  a.tail_lens = static_cast<const int*>(tail_lens);
  a.out = static_cast<bf16*>(out);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<unsigned*>(tickets);
  a.T = T;
  a.H_all = H_all;
  a.Hkv = Hkv;
  a.G = H_all / (n_seq * Hkv);
  a.n_seq = n_seq;
  a.Tcap = Tcap;
  a.layer = layer;
  a.R_seg = R_seg;
  a.tail_len = tail_len;
  a.S = S;
  a.mtc = mtc;
  a.rgs = rgs;
  a.scale = scale;
  return i4d::launch<i4d::BF16>(a, static_cast<cudaStream_t>(stream));
}
