// K1: causal GQA flash attention of T queries against the dense cache.
//
// Replaces kvzip_tpu/ops/flash.py::flash_attend (_flash_kernel). Key j of
// kv head h is visible to query i iff j < base_lens[h] + i + 1 (and j < C);
// fp32 online softmax; the denominator is guarded by 1e-37, so a row that
// sees no key gives 0.
//
// Bound on the H100: tensor-core operations at prefill and scoring shapes
// (4 * 128 flops a visible (query, key) pair: 0.851 ms at 4,096 queries
// after 12,288 rows, 28 heads, at 989 TFLOP/s).
//
// Design (Hopper's producer/consumer shape; the body is flash_sm90.cuh's,
// shared with K9 and K5/K6's prefill form, and this file holds K1's tile
// plan, CausalPlan): one CTA per (query head, block of
// BQ = 128 queries), the heads of one block adjacent in launch order so a kv
// head's tiles are read from device memory once and from the 50 MB L2 by the
// rest of its group (a layer's K/V is 33.5 MB at C = 16,384), which keeps the
// query tile a plain 128 x 128 box and every consumer row useful (packing the
// G heads into the rows, as the first mma.sync version did, pads 7 heads to
// 16-row multiples and ties the CTA's shape to G); blocks run heaviest (last)
// first. Warpgroup 0 is the producer: one thread issues TMA loads (128-byte
// swizzle) of the query tile once and of 128-key K and V tiles into a two-
// stage ring, with full and empty mbarriers, K and V on separate barriers so
// q.k starts before V lands. Warpgroups 1 and 2 each own 64 query rows: S = Q
// K^T by wgmma.m64n128k16 from shared memory, the online softmax in registers
// in base 2 (log2 e folded into the scale, ex2.approx), P rounded to bf16 in
// registers as the A operand of O += P V, with V the MN-major (transposed) B
// operand. setmaxnreg moves registers from the producer to the consumers. Only
// the tiles that reach past min(base + first query + 1, C) are masked; key
// tiles past min(base + last query + 1, C) are never loaded; rows past T
// (zero-filled by TMA) are not stored.
#include "flash_sm90.cuh"

using namespace fsm90;

namespace {

// Key j of kv head hk is visible to query row iff j < base + row + 1 and
// j < C; tiles up to min(base + last query + 1, C) are live, and those
// wholly below min(base + q0 + 1, C) need no mask.
struct CausalPlan {
  struct Args {
    const int* base_lens;
    int C;
  };
  int lim0, C, n, n_full;
  __device__ CausalPlan(const Args& a, int hk, int q0, int T) : C(a.C) {
    const int base = a.base_lens[hk];
    lim0 = base + 1;
    n = (min(base + min(q0 + BQ, T), C) + BKT - 1) / BKT;
    n_full = min(base + q0 + 1, C) / BKT;
  }
  __device__ int live() const { return n; }
  __device__ int tile(int i) const { return i; }
  __device__ bool full(int t) const { return t < n_full; }
  __device__ bool visible(int col, int row) const { return col < min(lim0 + row, C); }
};

}  // namespace

// q (T, H, D), k/v (Hkv, C, D) bf16, 16-byte aligned; base_lens (Hkv,) int32;
// out (T, H, D). Returns a CUDA error code (cudaErrorInvalidValue when a
// tensor map cannot be made).
extern "C" int kvz_flash_attend(const void* q, const void* k, const void* v,
                                const void* base_lens, void* out, int T, int H, int Hkv, int C,
                                float scale, void* stream) {
  return launch_bf16<CausalPlan>(q, k, v, {static_cast<const int*>(base_lens), C}, out, T, H,
                                 Hkv, C, scale, stream);
}
