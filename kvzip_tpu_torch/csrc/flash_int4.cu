// K5 and K6: causal GQA flash attention over the dense int4 cache.
//
// Replaces kvzip_tpu/ops/flash_int4.py::flash_attend_int4 (_kernel, K5)
// and ::flash_attend_int4_extra (_kernel_extra, K6). The cache holds
// split-packed int4 rows (Hkv, C, D/2) with one (scale, zero) per row
// (int4_common.cuh).
// - K5 (prefill chunks and decode on the dense int4 cache): the T new rows
//   were appended at base_lens[h]; key j is visible to query i iff
//   j < base_lens[h] + i + 1.
// - K6 (the read-only scoring forward): nothing is appended. Cache rows
//   [0, base_lens[h]) are visible to every query, and the chunk's own
//   quantized rows (T, Hkv, D/2), a second key source, are causal within
//   the chunk: extra row c is visible to query i iff c < i + 1.
//
// Bound on the H100: tensor-core operations at prefill and scoring shapes
// (0.851 ms at 4,096 queries after 12,288 rows, 28 heads; 0.591 ms at a
// 2,304-query scoring chunk after 16,544 rows); device-memory bytes at
// decode (T <= 16), where the int4 rows are 3.8x fewer bytes than bf16 rows.
//
// Prefill and scoring (T > 16): K1's structure (flash_sm90.cuh: a CTA per
// (query head, 128 queries), two consumer warpgroups of 64 rows on
// wgmma.m64n128k16, the base-2 online softmax in registers, P from
// registers) with an int4 front end. wgmma takes no int4 operand for a bf16
// product, so the producer warpgroup expands each tile: one thread issues
// TMA loads of the packed K and V tiles (uint8 tensor maps, 128 rows of 64
// bytes, a three-stage ring), and all 128 threads turn them into bf16 tiles
// in a two-stage ring, in the 128-byte-swizzle layout TMA gives K1 (16-byte
// chunk index XOR row % 8), then fence the async proxy and arrive on the
// stage's full barrier; they also read the tile's per-row scales and zeros
// with plain loads (the (Hkv, C) rows need C % 8 == 0 for TMA, the chunk's
// (T, Hkv) columns are strided), zeroed past the rows the source holds.
// Both tiles hold exact centred nibble values c = n - 8 (in [-8, 7]), so
// expansion is integer-to-bf16 with no float math: a byte permute builds
// the bf16 bits of 128 + n and one bf16x2 fma subtracts 136. The quant
// algebra (x = scale n + zero = scale c + zero', zero' = zero + 8 scale) is
// folded out of both products, as the TPU kernel does:
// - q.k = scale_k (q.c) + zero'_k sum(q), with the softmax scale and
//   log2 e folded into scale_k and zero'_k and sum(q) taken once from the Q
//   tile;
// - p.v = sum_k (p_k scale_v[k]) c_k + sum_k p_k zero'_v[k]: each p is
//   multiplied by its key's scale_v before it is rounded to bf16 as the A
//   operand, and the second sum is kept in float32 beside the row's
//   denominator and added to every column at the end. So the one bf16
//   rounding on the value side falls on p * scale_v (2^-9 of it) instead of
//   on p and on the dequantized value, as in the PR 1 loop. Centring keeps
//   that rounding from being amplified: with n in [0, 15] every term of the
//   first sum carries a common offset that the second sum cancels, and the
//   rounding error of the offset (about 3x the PR 1 loop's) does not cancel
//   with it.
// The i-th live tile (Int4Plan::tile: the cache's tiles up to the block's
// last visible row, then for K6 the chunk's tiles up to its last query) is
// one function both sides call. Tiles every row sees whole are not masked.
//
// Decode (T <= 16) runs K4's one-launch body instead (split_decode.cuh,
// its int4 row source): a grid of at most one CTA a SM, each head's live
// rows cut on the device into equal splits, the G * T rows packed 32 a
// CTA, a six-stage cp.async ring a warp of packed rows and their scales,
// keys as nibbles with the quant algebra folded out of q.k, V dequantized
// once a stage, and the splits' partials merged inside the launch, so a
// handful of queries still fills the card with one kernel. Bound there:
// the live rows' bytes (9.0 MB at 16,545 rows of qwen2.5-7b's 4 kv heads:
// 0.0027 ms at 3.35 TB/s).
#include <limits.h>

#include "flash_sm90.cuh"
#include "int4_common.cuh"
#include "split_decode.cuh"

using namespace kvz;

// ------------------------------------------------- prefill / scoring form
namespace {

using fsm90::BKT;
using fsm90::BQ;
using fsm90::HALF;
using fsm90::TILE;

constexpr int PK = BKT * DP;     // a packed 128-row tile, bytes
constexpr int P_STAGES = 3;      // packed ring (TMA -> expansion)
constexpr int E_STAGES = 2;      // expanded ring (expansion -> wgmma)
constexpr int SC_STAGE = BKT * 16;  // a stage's folded scales: 2 float2 a row
constexpr int I4_Q = 0;
constexpr int I4_EX = TILE;                              // K[s], V[s] = K[s] + TILE
constexpr int I4_PK = I4_EX + E_STAGES * 2 * TILE;       // packed K[s], V[s] = K[s] + PK
constexpr int I4_SC = I4_PK + P_STAGES * 2 * PK;
constexpr int I4_META = I4_SC + E_STAGES * SC_STAGE;     // a stage's tile, an int4
constexpr int I4_QS = I4_META + E_STAGES * 16;          // sum(q) of the Q tile's row pairs
constexpr int I4_BAR = I4_QS + BQ * 8;
constexpr int I4_SMEM = I4_BAR + 64 + 1024;  // barriers, 1 KB alignment slack
// the expanding producer keeps more registers than K1's (40)
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 168 * fsm90::THREADS,
              "setmaxnreg can only hand out the launch allocation");

// Visibility of key column col (counted from its source's start) to query
// row: col < min(a + b * row, cap).
struct Lim {
  int a, b, cap;
  __device__ bool visible(int col, int row) const { return col < min(a + b * row, cap); }
};

// What the consumers need of a stage's tile, written beside it by the
// producer so the consumers carry no plan: its first column (bit 31 set
// when every row sees the whole tile) and its Lim.
__device__ __forceinline__ int4 tile_meta(int col0, bool full, Lim lim) {
  return make_int4(col0 | (full ? INT_MIN : 0), lim.a, lim.b, lim.cap);
}

struct Int4Tile {
  int src, t;  // source (0 the cache, 1 the chunk's rows), 128-key tile in it
};

struct Int4Plan {
  int base, C, T, end0, n_cache, n, full0, full1;
  bool extra;
  __device__ Int4Plan(int base_, int C_, int T_, int q0, bool extra_)
      : base(base_), C(C_), T(T_), extra(extra_) {
    const int q_end = min(q0 + BQ, T);
    // cache rows the block reads: K6 all of [0, base), K5 up to its last query's
    end0 = extra ? min(base, C) : min(base + q_end, C);
    n_cache = (end0 + BKT - 1) / BKT;
    full0 = extra ? end0 / BKT : min(base + q0 + 1, C) / BKT;
    full1 = (q0 + 1) / BKT;
    n = n_cache + (extra ? (q_end + BKT - 1) / BKT : 0);
  }
  // the i-th live tile, on the producer's and the consumers' side alike
  __device__ Int4Tile tile(int i) const {
    return i < n_cache ? Int4Tile{0, i} : Int4Tile{1, i - n_cache};
  }
  __device__ bool full(Int4Tile x) const { return x.t < (x.src ? full1 : full0); }
  __device__ Lim lim(int src) const {
    if (src) return Lim{1, 1, INT_MAX};        // the chunk's rows: causal from 0
    if (extra) return Lim{end0, 0, end0};      // K6's cache rows: all of [0, base)
    return Lim{base + 1, 1, C};                // K5: j < base + row + 1
  }
  __device__ int rows(int src) const { return src ? T : end0; }  // rows with scales
};

// A float2 at a shared-memory address, loaded where the source puts it.
__device__ __forceinline__ float2 ld_shared_v2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// A float4 of shared memory, loaded where the source puts it. ptxas still
// hoists such loads within a warp's straight-line code, sixteen float4 of
// the consumers' per-column scales at once, and then spills around the p.v
// product (it allocates the consumers little above the launch bound's 168
// registers, whatever setmaxnreg grants); the loops cut it with a
// __syncwarp every four loads, which no shared load crosses.
__device__ __forceinline__ float4 ld_shared_v4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(sm90::smem_u32(p)));
  return v;
}

// bf16x2 bits of 128 + n (a nibble n in each byte of x's selected pair)
// times 1 minus 136: exact n - 8.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t x, uint32_t sel) {
  uint32_t y, b = __byte_perm(x, 0x43434343u, sel);
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(y) : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));
  return y;
}

// Packed words w0, w1 (bytes j..j+7 of a row) -> centred elements j..j+7
// of the high-nibble half (hi) and of the low-nibble half (lo).
__device__ __forceinline__ void expand8(uint32_t w0, uint32_t w1, uint4& hi, uint4& lo) {
  const uint32_t h0 = (w0 >> 4) & 0x0F0F0F0Fu, l0 = w0 & 0x0F0F0F0Fu;
  const uint32_t h1 = (w1 >> 4) & 0x0F0F0F0Fu, l1 = w1 & 0x0F0F0F0Fu;
  hi = make_uint4(nibbles_bf16(h0, 0x4140), nibbles_bf16(h0, 0x4342), nibbles_bf16(h1, 0x4140),
                  nibbles_bf16(h1, 0x4342));
  lo = make_uint4(nibbles_bf16(l0, 0x4140), nibbles_bf16(l0, 0x4342), nibbles_bf16(l1, 0x4140),
                  nibbles_bf16(l1, 0x4342));
}

// TMA loads of live tile x's packed K and V rows into dst (V PK bytes
// after K), counted on bar: the cache's rows (maps over (D/2, C, Hkv)) or
// the chunk's (maps over (D/2, Hkv, T)).
__device__ __forceinline__ void issue_packed(Int4Tile x, uint8_t* dst, uint64_t* bar,
                                             const CUtensorMap* kmap, const CUtensorMap* vmap,
                                             const CUtensorMap* xkmap, const CUtensorMap* xvmap,
                                             int hk) {
  sm90::mbar_expect_tx(bar, 2 * PK);
  if (x.src) {
    sm90::tma_load_3d(dst, xkmap, bar, 0, hk, x.t * BKT);
    sm90::tma_load_3d(dst + PK, xvmap, bar, 0, hk, x.t * BKT);
  } else {
    sm90::tma_load_3d(dst, kmap, bar, 0, x.t * BKT, hk);
    sm90::tma_load_3d(dst + PK, vmap, bar, 0, x.t * BKT, hk);
  }
}

struct Int4Scales {
  const bf16 *ks, *kz, *vs, *vz;  // the cache's (Hkv, C)
  const bf16 *xks, *xkz, *xvs, *xvz;  // the chunk's (T, Hkv); null for K5
};

__global__ void __launch_bounds__(fsm90::THREADS, 1)
    flash_int4_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap xkmap,
                            const __grid_constant__ CUtensorMap xvmap, const Int4Scales sc_in,
                            const int* __restrict__ base_lens, bf16* __restrict__ out, int T,
                            int H, int C, int G, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + I4_BAR);
  uint64_t* pk_full = bars;                          // [P_STAGES] packed tiles landed
  uint64_t* ex_full = bars + P_STAGES;               // [E_STAGES] expanded tiles written
  uint64_t* ex_empty = bars + P_STAGES + E_STAGES;   // [E_STAGES] consumers done
  uint64_t* q_full = bars + P_STAGES + 2 * E_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P_STAGES; ++s) sm90::mbar_init(&pk_full[s], 1);
    for (int s = 0; s < E_STAGES; ++s) {
      sm90::mbar_init(&ex_full[s], 128);
      sm90::mbar_init(&ex_empty[s], 256);
    }
    sm90::mbar_init(q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------ producer / expansion
    sm90::regs_dealloc<PRODUCER_REGS>();
    // each role derives its block's indices itself: values computed before
    // setmaxnreg and used after it are spilled across it
    const int h = blockIdx.x, hk = h / G, Hkv = H / G;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const Int4Plan plan(base_lens[hk], C, T, q0, sc_in.xks != nullptr);
    const int n_live = plan.n, tid = threadIdx.x;
    if (tid == 0) {
      sm90::mbar_expect_tx(q_full, TILE);
      sm90::tma_load_2d(smem + I4_Q, &qmap, q_full, h * D, q0);
      sm90::tma_load_2d(smem + I4_Q + HALF, &qmap, q_full, h * D + 64, q0);
      for (int i = 0; i < min(P_STAGES, n_live); ++i)
        issue_packed(plan.tile(i), smem + I4_PK + i * 2 * PK, &pk_full[i], &kmap, &vmap, &xkmap,
                     &xvmap, hk);
    }
    for (int i = 0; i < n_live; ++i) {
      const Int4Tile x = plan.tile(i);
      const int ps = i % P_STAGES, es = i % E_STAGES;
      // this thread's row of the tile: its folded scales (scale, zero +
      // 8 scale), 0 past the source
      const int row = x.t * BKT + tid;
      float2 kf = make_float2(0.f, 0.f), vf = make_float2(0.f, 0.f);
      if (row < plan.rows(x.src)) {
        const size_t g = x.src ? static_cast<size_t>(row) * Hkv + hk
                               : static_cast<size_t>(hk) * C + row;
        const float ks = __bfloat162float((x.src ? sc_in.xks : sc_in.ks)[g]);
        const float kz = __bfloat162float((x.src ? sc_in.xkz : sc_in.kz)[g]);
        const float vs = __bfloat162float((x.src ? sc_in.xvs : sc_in.vs)[g]);
        const float vz = __bfloat162float((x.src ? sc_in.xvz : sc_in.vz)[g]);
        kf = make_float2(ks * scale_log2, fmaf(8.f, ks, kz) * scale_log2);
        vf = make_float2(vs, fmaf(8.f, vs, vz));
      }
      sm90::mbar_wait(&pk_full[ps], (i / P_STAGES) & 1);
      if (i >= E_STAGES) sm90::mbar_wait(&ex_empty[es], ((i / E_STAGES) - 1) & 1);
      const uint8_t* pk = smem + I4_PK + ps * 2 * PK;
      uint8_t* ex = smem + I4_EX + es * 2 * TILE;
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // 4 16-byte chunks of K, then 4 of V
        const int idx = tid + 128 * (k & 3), r = idx >> 2, jc = idx & 3, sw = r & 7;
        const uint4 w = *reinterpret_cast<const uint4*>(pk + (k >> 2) * PK + idx * 16);
        uint8_t* dst = ex + (k >> 2) * TILE + r * 128;
        uint4 hi, lo;
        expand8(w.x, w.y, hi, lo);  // bytes jc*16.. -> 16-byte chunk 2 jc of each half
        *reinterpret_cast<uint4*>(dst + (((2 * jc) ^ sw) << 4)) = hi;
        *reinterpret_cast<uint4*>(dst + HALF + (((2 * jc) ^ sw) << 4)) = lo;
        expand8(w.z, w.w, hi, lo);  // and chunk 2 jc + 1
        *reinterpret_cast<uint4*>(dst + (((2 * jc + 1) ^ sw) << 4)) = hi;
        *reinterpret_cast<uint4*>(dst + HALF + (((2 * jc + 1) ^ sw) << 4)) = lo;
      }
      float2* scs = reinterpret_cast<float2*>(smem + I4_SC + es * SC_STAGE);
      scs[tid] = kf;
      scs[BKT + tid] = vf;
      if (tid == 0)
        *reinterpret_cast<int4*>(smem + I4_META + es * 16) =
            tile_meta(x.t * BKT, plan.full(x), plan.lim(x.src));
      sm90::fence_proxy_async_shared();
      sm90::mbar_arrive(&ex_full[es]);
      sm90::named_bar(1, 128);  // every thread is done reading packed stage ps
      if (tid == 0 && i + P_STAGES < n_live) {
        sm90::fence_proxy_async_shared();
        issue_packed(plan.tile(i + P_STAGES), smem + I4_PK + ps * 2 * PK, &pk_full[ps], &kmap,
                     &vmap, &xkmap, &xvmap, hk);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  sm90::regs_alloc<CONSUMER_REGS>();
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int n_live = Int4Plan(base_lens[h / G], C, T, q0, sc_in.xks != nullptr).n;
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int r_lo = c * 64 + (tid >> 5) * 16 + gid;  // row in the Q tile
  const int row_lo = q0 + r_lo, row_hi = row_lo + 8;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};

  const uint64_t qd0 = sm90::desc_sw128(smem + I4_Q + c * 64 * 128, 0, 1024);
  const uint64_t qd1 = sm90::desc_sw128(smem + I4_Q + HALF + c * 64 * 128, 0, 1024);
  sm90::mbar_wait(q_full, 0);
  // sum(q) of both rows: each lane of the quad adds 2 of the 8 16-byte
  // chunks of each half (a whole-row sum is blind to the swizzle)
  float qs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 w = *reinterpret_cast<const uint4*>(smem + I4_Q + (u >> 1) * HALF +
                                                      (r_lo + 8 * i) * 128 +
                                                      (tig * 2 + (u & 1)) * 16);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ws[e]));
        a += f.x + f.y;
      }
    }
    qs[i] = quad_sum(a);
  }
  // kept in shared memory and read once a tile: a register pair held across
  // the loop is spilled around the p.v product
  float2* qsum = reinterpret_cast<float2*>(smem + I4_QS) + r_lo;
  if (tig == 0) *qsum = make_float2(qs[0], qs[1]);
  const uint32_t qsum_at = sm90::smem_u32(qsum);
  __syncwarp();

  for (int i = 0; i < n_live; ++i) {
    const int es = i % E_STAGES;
    const uint8_t* ks = smem + I4_EX + es * 2 * TILE;
    const float4* kf = reinterpret_cast<const float4*>(smem + I4_SC + es * SC_STAGE);
    const float4* vf = kf + BKT / 2;

    float sc[64];
    sm90::mbar_wait(&ex_full[es], (i / E_STAGES) & 1);
    fsm90::qk_tile(sc, qd0, qd1, ks);
    const float2 qv = ld_shared_v2(qsum_at);
    // fold: (scale_k (q.c) + zero'_k sum(q)) * softmax scale * log2 e;
    // kf[j*4 + tig] holds the pairs of columns j*8 + 2 tig and + 1
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 f = ld_shared_v4(kf + j * 4 + tig);
      sc[j * 4 + 0] = fmaf(sc[j * 4 + 0], f.x, qv.x * f.y);
      sc[j * 4 + 1] = fmaf(sc[j * 4 + 1], f.z, qv.x * f.w);
      sc[j * 4 + 2] = fmaf(sc[j * 4 + 2], f.x, qv.y * f.y);
      sc[j * 4 + 3] = fmaf(sc[j * 4 + 3], f.z, qv.y * f.w);
      if ((j & 3) == 3) __syncwarp();  // at most 4 float4 of scales in flight
    }
    const int4 meta = *reinterpret_cast<const int4*>(smem + I4_META + es * 16);
    if (meta.x >= 0)  // not seen whole by every row
      fsm90::mask_tile(sc, Lim{meta.y, meta.z, meta.w}, meta.x, tig, row_lo, row_hi);

    float alpha[2];
    fsm90::softmax_tile(sc, o, m, l, alpha, 1.f);
    z[0] *= alpha[0];
    z[1] *= alpha[1];
    uint32_t pa[8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 f = ld_shared_v4(vf + j * 4 + tig);  // (scale_v, zero'_v), 2 columns
      z[0] = fmaf(sc[j * 4 + 0], f.y, fmaf(sc[j * 4 + 1], f.w, z[0]));
      z[1] = fmaf(sc[j * 4 + 2], f.y, fmaf(sc[j * 4 + 3], f.w, z[1]));
      pa[j >> 1][(j & 1) * 2 + 0] = pack_f32(sc[j * 4 + 0] * f.x, sc[j * 4 + 1] * f.z);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_f32(sc[j * 4 + 2] * f.x, sc[j * 4 + 3] * f.z);
      if ((j & 3) == 3) __syncwarp();
    }
    fsm90::pv_tile(o, pa, ks + TILE);
    sm90::mbar_arrive(&ex_empty[es]);
  }

  const float zs[2] = {quad_sum(z[0]), quad_sum(z[1])};
  fsm90::store_rows(o, l, zs, out, row_lo, row_hi, T, H, h, tig);
}

// Tensor maps of q (T, H, D) bf16, the cache's packed rows (Hkv, C, D/2)
// and, for K6, the chunk's (T, Hkv, D/2); launches the kernel.
int launch_wgmma(const void* q, const void* kq, const void* vq, const void* xkq, const void* xvq,
                 const Int4Scales& sc, const void* base_lens, void* out, int T, int H, int Hkv,
                 int C, float scale, void* stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(flash_int4_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, I4_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  CUtensorMap qmap, kmap, vmap, xkmap, xvmap;
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(H) * D, static_cast<cuuint64_t>(T)};
  const cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(H) * D * 2};
  const cuuint32_t qbox[2] = {64, BQ};
  const cuuint64_t cdims[3] = {DP, static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(Hkv)};
  const cuuint64_t cstrides[2] = {DP, static_cast<cuuint64_t>(C) * DP};
  const cuuint32_t cbox[3] = {DP, BKT, 1};
  const cuuint64_t xdims[3] = {DP, static_cast<cuuint64_t>(Hkv), static_cast<cuuint64_t>(T)};
  const cuuint64_t xstrides[2] = {DP, static_cast<cuuint64_t>(Hkv) * DP};
  const cuuint32_t xbox[3] = {DP, 1, BKT};
  if (!sm90::bf16_map(&qmap, q, 2, qdims, qstrides, qbox) ||
      !sm90::u8_map(&kmap, kq, 3, cdims, cstrides, cbox) ||
      !sm90::u8_map(&vmap, vq, 3, cdims, cstrides, cbox))
    return static_cast<int>(cudaErrorInvalidValue);
  if (xkq) {
    if (!sm90::u8_map(&xkmap, xkq, 3, xdims, xstrides, xbox) ||
        !sm90::u8_map(&xvmap, xvq, 3, xdims, xstrides, xbox))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    xkmap = kmap;  // K5 reads no chunk rows
    xvmap = vmap;
  }
  dim3 grid(H, (T + BQ - 1) / BQ);
  flash_int4_wgmma_kernel<<<grid, fsm90::THREADS, I4_SMEM, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, xkmap, xvmap, sc, static_cast<const int*>(base_lens),
      static_cast<bf16*>(out), T, H, C, H / Hkv, scale * fsm90::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5 (T > 16 from the wrapper). q (T, H, D) bf16; k_q/v_q (Hkv, C, D/2)
// uint8; k_s/k_z/v_s/v_z (Hkv, C) bf16; base_lens (Hkv,) int32; out
// (T, H, D) bf16; q, k_q and v_q 16-byte aligned.
extern "C" int kvz_flash_int4(const void* q, const void* kq, const void* ks, const void* kz,
                              const void* vq, const void* vs, const void* vz,
                              const void* base_lens, void* out, int T, int H, int Hkv, int C,
                              float scale, void* stream) {
  const Int4Scales sc{static_cast<const bf16*>(ks), static_cast<const bf16*>(kz),
                      static_cast<const bf16*>(vs), static_cast<const bf16*>(vz),
                      nullptr, nullptr, nullptr, nullptr};
  return launch_wgmma(q, kq, vq, nullptr, nullptr, sc, base_lens, out, T, H, Hkv, C, scale,
                      stream);
}

// K5, decode form (T <= 16 from the wrapper): as kvz_flash_int4, with
// the scratch, tickets and plan split_decode.cuh's launch takes.
extern "C" int kvz_flash_int4_decode(const void* q, const void* kq, const void* ks,
                                     const void* kz, const void* vq, const void* vs,
                                     const void* vz, const void* base_lens, void* out,
                                     void* part_acc, void* part_ml, void* tickets, int T, int H,
                                     int Hkv, int C, int S, float scale, void* stream) {
  const sdec::Int4Src::Args args{static_cast<const uint8_t*>(kq), static_cast<const bf16*>(ks),
                                 static_cast<const bf16*>(kz),    static_cast<const uint8_t*>(vq),
                                 static_cast<const bf16*>(vs),    static_cast<const bf16*>(vz),
                                 Hkv};
  return sdec::launch<sdec::Int4Src>(q, args, base_lens, out, part_acc, part_ml, tickets, T, H,
                                     Hkv, C, S, scale, stream);
}

// K6. As kvz_flash_int4 with nothing appended, plus the chunk's own rows:
// x_kq/x_vq (T, Hkv, D/2) uint8 (16-byte aligned) and x_ks/x_kz/x_vs/x_vz
// (T, Hkv) bf16.
extern "C" int kvz_flash_int4_extra(const void* q, const void* kq, const void* ks,
                                    const void* kz, const void* vq, const void* vs,
                                    const void* vz, const void* base_lens, const void* x_kq,
                                    const void* x_ks, const void* x_kz, const void* x_vq,
                                    const void* x_vs, const void* x_vz, void* out, int T, int H,
                                    int Hkv, int C, float scale, void* stream) {
  const Int4Scales sc{static_cast<const bf16*>(ks),   static_cast<const bf16*>(kz),
                      static_cast<const bf16*>(vs),   static_cast<const bf16*>(vz),
                      static_cast<const bf16*>(x_ks), static_cast<const bf16*>(x_kz),
                      static_cast<const bf16*>(x_vs), static_cast<const bf16*>(x_vz)};
  return launch_wgmma(q, kq, vq, x_kq, x_vq, sc, base_lens, out, T, H, Hkv, C, scale, stream);
}
