// K4: decode attention (T <= 8 queries) against the dense cache with
// per-head live lengths.
//
// Replaces kvzip_tpu/ops/ragged_decode.py::ragged_decode_attend
// (_decode_kernel). Head h's live keys are rows [0, min(base_lens[h] + T, C)):
// the T new rows were appended at base_lens[h] and are causal among
// themselves (key j visible to query i iff j < base_lens[h] + i + 1).
//
// Bound on the H100: device-memory bytes, each live K/V row read once
// (33.9 MB at 16,545 rows of qwen2.5-7b's 4 kv heads: 0.0101 ms at 3.35 TB/s).
// Design: split_decode.cuh's one-launch body (shared with K5's decode
// form) over bf16 rows: a grid of at most one CTA a SM, each head's live
// rows cut on the device into S equal 16-key-aligned splits, the GQA group
// and the T queries packed 32 rows a CTA, a four-stage cp.async ring a
// warp (ldmatrix for K, ldmatrix.trans for V), a base-2 online softmax,
// and the head's first 8 splits merging every split's partial, a column
// slice each, once a release count of them is complete.
//
// Tried and measured (tools/k4_variants.py, NVIDIA H100 80GB HBM3, 700.00 W):
// the first version's merge kernel took 62% of 0.063 ms; the last CTA of a
// head merging all 33 partials took 7.5 us of 24 us (one SM's copies of 118 KB
// are slow, however issued: cp.async per thread or TMA); merging in 8-CTA
// clusters through distributed shared memory left clusters waiting for SMs
// (some of 16 started 16 us late); per-split ready flags polled with acquire
// loads, and copies issued by few threads, serialised. Deeper (6) or shallower
// (2) rings change nothing: the compute hides under the loads.
#include "split_decode.cuh"

// q (T, H, D), k/v (Hkv, C, D) bf16; base_lens (Hkv,) int32; out (T, H, D);
// scratch, tickets and the plan as split_decode.cuh's launch takes them.
extern "C" int kvz_ragged_decode(const void* q, const void* k, const void* v,
                                 const void* base_lens, void* out, void* part_acc, void* part_ml,
                                 void* tickets, int T, int H, int Hkv, int C, int S, float scale,
                                 void* stream) {
  const sdec::Bf16Src::Args args{static_cast<const kvz::bf16*>(k),
                                 static_cast<const kvz::bf16*>(v)};
  return sdec::launch<sdec::Bf16Src>(q, args, base_lens, out, part_acc, part_ml, tickets, T, H,
                                     Hkv, C, S, scale, stream);
}
