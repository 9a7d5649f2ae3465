// K9: attention output of the windowed scoring pass.
//
// Replaces kvzip_tpu/ops/windowed_attend.py::windowed_attend
// (_windowed_attend_kernel). The repeat-pass queries attend only
// keys = [sink | ctx window (s_ctx) | repeat (T)] of their kv head instead of
// the whole cache: causal on the trailing repeat block only (column
// c >= sink + s_ctx is visible to query t iff c - sink - s_ctx <= t), the
// padded window columns [sink + ctx_len, sink + s_ctx) dropped, padded query
// rows computed like any other (the engine discards them). fp32 softmax,
// bf16 output.
//
// Bound on the H100: tensor-core operations (T in the thousands against
// sink + s_ctx + T keys per kv head: 0.129 ms at llama3.1-8b's 2,304
// queries, ctx_len 2,000).
// Design: the TPU kernel held one kv head's whole key set (~4.5k rows, 1.1 MB
// each for K and V in bf16) in VMEM and took a one-shot softmax; that is far
// above the 227 KB of shared memory a CTA has, so this is K1's kernel
// (flash_sm90.cuh: TMA into a two-stage ring, a producer warpgroup, two
// consumer warpgroups on wgmma, a CTA per query head and 128 queries) over
// the concatenated keys, which the wrapper builds; the sink is not
// tile-aligned, so 128-key tiles run over the concatenation, through a 3-D
// tensor map (D, K, Hkv) whose byte strides (256 and 256 K) suit TMA for any
// K. WindowPlan lists the live tiles: those below the pad's start, then
// those from the repeat block's start (or the first tile not yet listed) up
// to the block's last query; a tile wholly inside the pad, and a repeat tile
// past the block's last query, is never loaded. A tile is masked where it
// straddles the pad's start, the repeat block's start or the causal edge.
#include "flash_sm90.cuh"

using namespace fsm90;

namespace {

struct WindowPlan {
  struct Args {
    int sink, s_ctx, ctx_len;
  };
  int pad0, s0, edge, n_a, t_b, n;
  __device__ WindowPlan(const Args& a, int hk, int q0, int T) {
    pad0 = a.sink + a.ctx_len;  // first dropped window column
    s0 = a.sink + a.s_ctx;      // first repeat column
    edge = s0 + q0 + 1;         // repeat columns below it: seen by every row of the block
    const int kv_end = s0 + min(q0 + BQ, T);
    n_a = (pad0 + BKT - 1) / BKT;  // tiles [0, n_a) reach below pad0
    t_b = max(n_a, s0 / BKT);      // then tiles [t_b, ceil(kv_end / BKT))
    n = n_a + max(0, (kv_end + BKT - 1) / BKT - t_b);
  }
  __device__ int live() const { return n; }
  // the i-th live tile, on the producer's and the consumers' side alike
  __device__ int tile(int i) const { return i < n_a ? i : t_b + (i - n_a); }
  __device__ bool full(int t) const {
    const int lo = t * BKT, hi = lo + BKT;
    if (hi <= pad0) return true;            // sink and window only
    if (lo < s0 && pad0 < s0) return false;  // touches the dropped columns
    return hi <= edge;
  }
  __device__ bool visible(int col, int row) const {
    return col < pad0 || (col >= s0 && col - s0 <= row);
  }
};

}  // namespace

// q (T, H, D); keys/vals (Hkv, K, D) bf16 with K = sink + s_ctx + T, each
// 16-byte aligned; out (T, H, D) bf16. Returns a CUDA error code.
extern "C" int kvz_windowed_attend(const void* q, const void* keys, const void* vals, void* out,
                                   int T, int H, int Hkv, int K, int sink, int s_ctx,
                                   int ctx_len, float scale, void* stream) {
  return launch_bf16<WindowPlan>(q, keys, vals, {sink, s_ctx, ctx_len}, out, T, H, Hkv, K, scale,
                                 stream);
}
