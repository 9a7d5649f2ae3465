// K8: W4A8 linear over one layer of a stacked int4 weight (T < 512 rows).
//
// Replaces kvzip_tpu/ops/w4a8_v2.py::w4a8_matmul_stacked_v2
// (_w4a8_v2_kernel). Storage as in the reference's v2 layout: bytes
// (L, IN, OUT/2) split-packed along OUT (byte column j holds output column
// j in the high nibble and j + OUT/2 in the low nibble) and stored XOR 0x80;
// bf16 s2/z2 (L, 2, Gp8, OUT/2) per (nibble half, group of 128 input rows,
// byte column), the high half pre-folded as s_hi / 16 and z_hi + 8 s_hi.
// Activations round per token to s8 (ops/quant.py::quantize_act_int8:
// amax / 127 + 1e-8, round half to even).
//
// Bound on the H100: device-memory bytes at decode (T = 1 reads every
// weight byte for 2 operations per nibble); s8 tensor-core operations
// toward the 511 rows the dispatch sends here at most.
//
// Design: the Hopper body of w4a8_sm90.cuh (TMA boxes on an mbarrier ring,
// mma.sync s8, split-K items taken every grid-th, the partials merged in
// the launch, one launch at T <= 4) with the v2 scale source: the scale
// rows of (half h, group g) at (h Gp8 + g) OUT/2, un-primed in float32.
#include "w4a8_sm90.cuh"

#ifdef K8_STAMPS
extern "C" int kvz_w4a8_stamps(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(k8::k8_stamps, &buf, sizeof(buf)));
}
#endif

// x (T, IN) bf16; w (IN, OUT/2) uint8 and s2/z2 (2, Gp8, OUT/2) bf16, one
// layer's slices; out (T, OUT) bf16. The plan and the scratch:
// w4a8_sm90.cuh::run.
extern "C" int kvz_w4a8(const void* x, const void* w, const void* s2, const void* z2, void* out,
                        void* part, void* tickets, void* xq, void* xs, void* xsum, int T, int IN,
                        int OUT, int Gp8, int nt, int occ, int inq, int gps, int S, int grid,
                        void* stream) {
  const long long half = OUT / 2;
  return k8::run<true>(x, w, s2, z2, nullptr, out, part, tickets, xq, xs, xsum, T, IN, OUT,
                       Gp8 * half, half, nt, occ, inq, gps, S, grid, stream);
}
