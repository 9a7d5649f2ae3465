// K15/K16: W4A8 linear over the v1 storage, one layer of a stack (K15) or
// one unstacked weight with a bias (K16).
//
// Replaces kvzip_tpu/ops/w4a8.py::w4a8_matmul_stacked (_w4a8_stacked_kernel)
// and w4a8_matmul (_w4a8_kernel). v1 storage: bytes (L, INp, OUT/2) uint8
// split-packed along OUT (byte column j holds output column j in the high
// nibble and j + OUT/2 in the low nibble) and stored XOR 0x80; bf16 s, z
// (L, Gp, OUT) per (group of 128 input rows, output column), not pre-folded;
// INp = 128 Gp pads the input rows, and the pad groups carry s = z = 0.
// Activations round per token to s8 (ops/quant.py::quantize_act_int8).
//
// Bound on the H100: device-memory bytes at decode (T = 1 reads every
// weight byte for 2 operations per nibble); s8 tensor-core operations
// toward the 511 rows the dispatch sends here at most.
//
// Design: K8's Hopper body (w4a8_sm90.cuh) with the v1 scale source: the
// unit's scale rows are s[g, cb 128 ..] and z[g, cb 128 ..] (high nibbles)
// and s[g, OUT/2 + cb 128 ..], z[g, OUT/2 + cb 128 ..] (low nibbles), taken
// in float32 as they are (the plain version expands them so). The weight's
// tensor map covers the layer's first IN rows: only the G = IN / 128 true
// groups are read, never a pad group or the next layer's bytes. The bias
// (K16) is added by the CTA that writes the output (an item at S = 1, a
// block's merge above), after the cast to bf16, and rounded again.
#include "w4a8_sm90.cuh"

// x (T, IN) bf16; w the layer's bytes (INp, OUT/2) uint8, of which the
// first IN rows are read; s/z the layer's (Gp, OUT) bf16; bias (OUT,) bf16
// or null; out (T, OUT) bf16. The plan (ops/w4a8_v2.py::plan) and the
// scratch: w4a8_sm90.cuh::run.
extern "C" int kvz_w4a8_v1(const void* x, const void* w, const void* s, const void* z,
                           const void* bias, void* out, void* part, void* tickets, void* xq,
                           void* xs, void* xsum, int T, int IN, int OUT, int nt, int occ, int inq,
                           int gps, int S, int grid, void* stream) {
  return k8::run<false>(x, w, s, z, bias, out, part, tickets, xq, xs, xsum, T, IN, OUT, OUT / 2,
                        OUT, nt, occ, inq, gps, S, grid, stream);
}
