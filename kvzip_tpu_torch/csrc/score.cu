// K2: KVzip reconstruction scores of one layer and one scoring chunk.
//
// Replaces kvzip_tpu/ops/score_kernel.py::fused_scores (_score_kernel).
// Keys are [sink | ctx window (s_ctx) | repeat (T)]. Logits (q . k) * scale
// are rounded to bf16 before a full softmax over all visible keys; only the
// repeat block is causal; window columns at or past ctx_len are masked;
// queries at or past q_valid contribute nothing; the score is the max over
// (GQA group, query) of the window columns' probabilities, zero past
// ctx_len. No probability tensor reaches device memory.
//
// Bound on the H100: tensor-core operations, one q . k a visible (query,
// key) pair (H [q_valid (sink + ctx_len) + q_valid (q_valid + 1) / 2] 2 D:
// 0.046 ms at the smoke's chunk), then the pass-1 exponentials, one a
// visible pair (16 a clock an SM: ~0.05 ms there).
//
// Design (K1's TMA and wgmma shape, flash_sm90.cuh, without the value
// side): one CTA per (kv head, block of nq queries). The CTA holds the Q
// rows of all G heads of its block, packed (query, head) as one TMA box
// (dims D, H, T; box 64 x G x nq; nq G <= 256 rows, 4 64-row tiles), so
// each K tile leaves L2 once a CTA and is multiplied against every head of
// the group. The wrapper picks nq (ops/score_kernel.py::plan) so the grid
// fills the card. Thread 0 issues the TMA loads of the Q box and of 128-key
// K tiles (128-byte swizzle) into a three-stage ring with full and empty
// mbarriers, a tile ahead. Two consumer warpgroups (all the CTA's threads)
// take the CTA's 64-row tiles in turn and run wgmma.m64n128k16 q . k from
// shared memory, a row tile's scores used while the next one's product
// runs. The loads and the products walk the same tile plan (ScorePlan):
// pass 1 the tiles of [0, sink + ctx_len) from column 0, then the repeat
// tiles from its start up to the block's last valid query; pass 2 the
// window tiles from column sink. A tile no row sees is never loaded, and
// only edge tiles are masked. Alternatives measured by
// tools/score_variants.py (and in PERF.md): 64-key half tiles, three
// consumer warpgroups, up to 512 rows a CTA, rounding by integer ops, a
// mask select on every tile.
// - Pass 1: each row's max m and denominator l in base 2: the bf16
//   rounding falls on the natural-scale logit, as the reference's does,
//   and log2 e is applied after it in one FMA; ex2.approx.
// - Pass 2: the window tiles again, y = x log2 e - lse2 a row (lse2 =
//   m + log2 l, in shared memory), transposed (keys the accumulator's
//   rows, Q rows its columns: each warpgroup takes 64 keys of a tile
//   against 128 Q rows at a time), so the max over the CTA's rows is a
//   thread's own columns and then its quad's; one exponential a column,
//   folded into `out` with atomicMax on the float bits, which is exact and
//   order-independent because the scores are >= 0 and `out` starts at
//   zero (the launcher zeroes it). exp(x - m - ln l) differs from
//   exp(x - m) / l by a few float32 ulps.
#include "flash_sm90.cuh"

using namespace fsm90;

namespace {

constexpr int RT_MAX = 4;                // 64-row tiles a CTA
constexpr int ROWS = RT_MAX * 64;        // (query, head) rows a CTA, at most
constexpr int QHALF = ROWS * 128;        // one 64-column half of the Q rows, bytes
constexpr int CWG = 2;                   // consumer warpgroups (pass 2: 64 keys each)
static_assert(RT_MAX <= 2 * CWG, "at most two row tiles a warpgroup: two products in flight");
constexpr int NSTAGE = 3;
constexpr int K_TILE = 2 * HALF;         // a 128-key tile, both halves
constexpr int OFF_K = 2 * QHALF;
constexpr int OFF_LSE = OFF_K + NSTAGE * K_TILE;           // lse2 of each Q row
constexpr int OFF_BAR = OFF_LSE + ROWS * 4;
constexpr int SMEM = OFF_BAR + 64 + 1024;                 // barriers, 1 KB alignment slack
// The consumer warpgroups alone, thread 0 also issuing the TMA loads: two
// warps a scheduler leave a thread 255 registers. A producer warpgroup
// capped it at 168 (ptxas keeps the launch bound's count whatever
// setmaxnreg grants) and a ninth warp at 168 too (three warps on one
// scheduler's 16,384 registers); either spilled in pass 2.
constexpr int NTHR = 128 * CWG;
static_assert(SMEM <= 232448, "shared memory");

// The tiles one CTA visits, on the loads' and the products' side
// alike. Pass 1: tiles [0, n_a) from column 0 (visible: col < lim_a), then
// n_b repeat tiles from column s0 (repeat column t visible to query row r
// iff t <= r); pass 2: n_w window tiles from column sink (visible: window
// column < ctx_len, rows of the block's valid queries only).
struct ScorePlan {
  int lim_a, s0, sink, ctx_len, q0, n_a, n1, n;
  __device__ ScorePlan(int sink_, int s_ctx, int ctx_len_, int q0_, int q_end)
      : lim_a(sink_ + ctx_len_), s0(sink_ + s_ctx), sink(sink_), ctx_len(ctx_len_), q0(q0_) {
    n_a = (lim_a + BKT - 1) / BKT;
    n1 = n_a + (q_end + BKT - 1) / BKT;
    n = n1 + (ctx_len + BKT - 1) / BKT;
  }
  __device__ int col0(int i) const {
    return i < n_a ? i * BKT : i < n1 ? s0 + (i - n_a) * BKT : sink + (i - n1) * BKT;
  }
  // whether some (row, column) pair of tile i is hidden from a row of the block
  __device__ bool masked(int i) const {
    if (i < n_a) return (i + 1) * BKT > lim_a;
    if (i < n1) return (i - n_a + 1) * BKT > q0 + 1;
    return true;  // pass 2 also drops the invalid rows
  }
};

// Issues (without waiting) d = Q rows of row tile rt . the K tile's 128
// keys^T, one commit group; Q's and the keys' two 64-column boxes lie
// QHALF and HALF bytes apart, a 16-deep step is +2 in the descriptors'
// 16-byte units.
__device__ __forceinline__ void issue_q128(float (&d)[64], const uint8_t* smem, int rt,
                                           const uint8_t* ks) {
  const uint64_t qd0 = sm90::desc_sw128(smem + rt * 8192, 0, 1024);
  const uint64_t qd1 = sm90::desc_sw128(smem + QHALF + rt * 8192, 0, 1024);
  const uint64_t kd0 = sm90::desc_sw128(ks, 0, 1024), kd1 = sm90::desc_sw128(ks + HALF, 0, 1024);
  sm90::fence_regs(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t adv = static_cast<uint64_t>((kk & 3) * 2);
    sm90::wgmma_m64n128k16_ss(d, (kk < 4 ? qd0 : qd1) + adv, (kk < 4 ? kd0 : kd1) + adv, kk);
  }
  sm90::wgmma_commit();
}

// Issues (without waiting) d = K rows (64 keys: both 64-column boxes of
// the K tile at ka0 / ka1) . Q rows (128: the Q boxes at qb0 / qb1)^T: the
// transposed product of pass 2.
__device__ __forceinline__ void issue_kq(float (&d)[64], const uint8_t* ka0, const uint8_t* ka1,
                                         const uint8_t* qb0, const uint8_t* qb1) {
  const uint64_t kd0 = sm90::desc_sw128(ka0, 0, 1024), kd1 = sm90::desc_sw128(ka1, 0, 1024);
  const uint64_t qd0 = sm90::desc_sw128(qb0, 0, 1024), qd1 = sm90::desc_sw128(qb1, 0, 1024);
  sm90::fence_regs(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t adv = static_cast<uint64_t>((kk & 3) * 2);
    sm90::wgmma_m64n128k16_ss(d, (kk < 4 ? kd0 : kd1) + adv, (kk < 4 ? qd0 : qd1) + adv, kk);
  }
  sm90::wgmma_commit();
}

// x -> bf16(x * scale) of each score, in pairs (one cvt.rn.bf16x2 a pair)
template <int N>
__device__ __forceinline__ void round_logits(float (&sc)[N], float scale) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const uint32_t u = kvz::pack_f32(sc[2 * j] * scale, sc[2 * j + 1] * scale);
    sc[2 * j] = __uint_as_float(u << 16);
    sc[2 * j + 1] = __uint_as_float(u & 0xffff0000u);
  }
}

// sc[j*4 + e] is (row lo | hi by e >> 1, column j*8 + 2 tig + (e & 1) of
// the tile): hidden where the column is not below the row's limit
template <int N>
__device__ __forceinline__ void mask_cols(float (&sc)[N], const int (&lim)[2], int tig) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[j * 4 + e] = j * 8 + tig * 2 + (e & 1) < lim[e >> 1] ? sc[j * 4 + e] : -INFINITY;
}

// One online step of the running max m (base 2) and lane-partial
// denominator l of the thread's two rows over a tile's logits x:
// l = l 2^(m_old - m) + sum 2^(x log2 e - m).
template <int N>
__device__ __forceinline__ void row_stats(const float (&sc)[N], float (&m)[2], float (&l)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[j * 4 + 0], sc[j * 4 + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[j * 4 + 2], sc[j * 4 + 3]));
  }
  float mu[2], acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], kvz::quad_max(mx[r]) * LOG2E);
    mu[r] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet keeps l = 0
    l[r] *= sm90::ex2(m[r] - mu[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e >> 1][j & 1] += sm90::ex2(fmaf(sc[j * 4 + e], LOG2E, -mu[e >> 1]));
  l[0] += acc[0][0] + acc[0][1];
  l[1] += acc[1][0] + acc[1][1];
}

template <int RTW>
__global__ void __launch_bounds__(NTHR, 1)
    score_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap, float* __restrict__ out, int T,
                 int G, int nq, int sink, int s_ctx, int ctx_len, int q_valid, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* full = bars;             // [NSTAGE]
  uint64_t* empty = bars + NSTAGE;   // [NSTAGE]
  uint64_t* q_full = bars + 2 * NSTAGE;

  const int hk = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * nq;  // heaviest blocks first
  const int q_end = min(q0 + nq, min(q_valid, T));
  const ScorePlan plan(sink, s_ctx, ctx_len, q0, q_end);
  const int rows = nq * G, n_rt = (rows + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * CWG);
    }
    sm90::mbar_init(q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 also feeds the ring: the Q box and the first NSTAGE tiles
  // now, then at the top of tile i (no wgmma in flight) tile i - 1 +
  // NSTAGE into the stage tile i - 1 leaves, once both warpgroups are
  // done with it.
  auto load_tile = [&](int i) {
    const int s = i % NSTAGE;
    uint8_t* ks = smem + OFF_K + s * K_TILE;
    sm90::mbar_expect_tx(&full[s], K_TILE);
    sm90::tma_load_3d(ks, &kmap, &full[s], 0, plan.col0(i), hk);
    sm90::tma_load_3d(ks + HALF, &kmap, &full[s], 64, plan.col0(i), hk);
  };
  auto refill = [&](int i) {
    const int j = i - 1 + NSTAGE;
    if (threadIdx.x == 0 && i >= 1 && j < plan.n) {
      sm90::mbar_wait(&empty[(i - 1) % NSTAGE], ((i - 1) / NSTAGE) & 1);
      load_tile(j);
    }
  };
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(q_full, 2 * rows * 128);
    sm90::tma_load_3d(smem, &qmap, q_full, 0, hk * G, q0);
    sm90::tma_load_3d(smem + QHALF, &qmap, q_full, 64, hk * G, q0);
    for (int i = 0; i < min(NSTAGE, plan.n); ++i) load_tile(i);
  }

  // -------------------------------------------------------------- consumers
  // Warpgroup c takes RTW row tiles, c, c + CWG, ...: each key tile's
  // products for all of them are issued at once, and a row tile's scores
  // are used while the next one's product runs. Every warpgroup walks the
  // same RTW, a template parameter, so no branch surrounds a wgmma or a
  // use of its scores (where ptxas cannot prove a path uniform it
  // serializes every wgmma, C7518). A row tile past the CTA's last is a
  // copy of the last whose rows fall past q_end.
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid >> 5;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  // the query of the thread's rows (lo, hi) in each of its row tiles;
  // padding rows past nq G fall past q_end
  int qrow[RTW][2];
#pragma unroll
  for (int u = 0; u < RTW; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qrow[u][i] = q0 + ((c + u * CWG) * 64 + warp * 16 + gid + 8 * i) / G;
  float m[RTW][2], l[RTW][2];
#pragma unroll
  for (int u = 0; u < RTW; ++u) m[u][0] = m[u][1] = -INFINITY, l[u][0] = l[u][1] = 0.f;

  sm90::mbar_wait(q_full, 0);
  float f1[RTW][64];

  // pass 1: each row's max and denominator (base 2)
  for (int i = 0; i < plan.n1; ++i) {
    refill(i);
    const int s = i % NSTAGE;
    const uint8_t* ks = smem + OFF_K + s * K_TILE;
    const bool msk = plan.masked(i);
    const int rep = i - plan.n_a;  // repeat tile index (pass 1's second part)
    sm90::mbar_wait(&full[s], (i / NSTAGE) & 1);
#pragma unroll
    for (int u = 0; u < RTW; ++u) issue_q128(f1[u], smem, min(c + u * CWG, n_rt - 1), ks);
#pragma unroll
    for (int u = 0; u < RTW; ++u) {
      float (&sc)[64] = f1[u];
      if (u + 1 < RTW) sm90::wgmma_wait<1>(); else sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      if (u + 1 == RTW && lane == 0) sm90::mbar_arrive(&empty[s]);  // the warp is done with the tile
      round_logits(sc, scale);
      // edge tiles only: the branch is the same for the whole CTA (a select
      // an element on every tile was 2% slower, tools/score_variants.py)
      if (msk) {
        const int lim[2] = {rep < 0 ? plan.lim_a - i * BKT : qrow[u][0] - rep * BKT + 1,
                            rep < 0 ? plan.lim_a - i * BKT : qrow[u][1] - rep * BKT + 1};
        mask_cols(sc, lim, tig);
      }
      row_stats(sc, m[u], l[u]);
    }
  }

  // lse2 = m + log2 l of each row; rows past q_end hidden from pass 2
  float lse[RTW][2];
#pragma unroll
  for (int u = 0; u < RTW; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = kvz::quad_sum(l[u][r]);
      lse[u][r] = qrow[u][r] < q_end ? m[u][r] + __log2f(den) : INFINITY;
    }

  // pass 2: the window columns' max over the CTA's rows of x log2 e - lse2,
  // transposed: warpgroup c multiplies its 64 keys of the tile (A, from
  // the K tile) by 128 Q rows at a time (B), so a key is a row of the
  // accumulator and its max over the queries is the thread's own columns,
  // then its quad's: no exchange between warps, one exponential and one
  // atomicMax a column.
  float* lse_s = reinterpret_cast<float*>(smem + OFF_LSE);
#pragma unroll
  for (int u = 0; u < RTW; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (tig == 0) lse_s[(c + u * CWG) * 64 + warp * 16 + gid + 8 * r] = lse[u][r];
  __syncthreads();
  unsigned* dst = reinterpret_cast<unsigned*>(out) + static_cast<size_t>(hk) * s_ctx;
  float pp[2][64];
  for (int i = plan.n1; i < plan.n; ++i) {
    refill(i);
    const int s = i % NSTAGE, key0 = (i - plan.n1) * BKT + c * 64 + warp * 16 + gid;
    const uint8_t* ks = smem + OFF_K + s * K_TILE;
    float best[2] = {-INFINITY, -INFINITY};
    sm90::mbar_wait(&full[s], (i / NSTAGE) & 1);
    issue_kq(pp[0], ks + c * 8192, ks + HALF + c * 8192, smem, smem + QHALF);
#pragma unroll
    for (int k = 0; k < RTW; ++k) {  // Q rows 128 k .. 128 k + 127
      float (&st)[64] = pp[k & 1];
      if (k + 1 < RTW)
        issue_kq(pp[(k + 1) & 1], ks + c * 8192, ks + HALF + c * 8192, smem + (k + 1) * 16384,
                 smem + QHALF + (k + 1) * 16384);
      if (k + 1 < RTW) sm90::wgmma_wait<1>(); else sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      if (k == RTW - 1 && lane == 0) sm90::mbar_arrive(&empty[s]);  // the warp is done with the tile
      round_logits(st, scale);
      const float2* ls = reinterpret_cast<const float2*>(lse_s + k * 128 + tig * 2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 lv = ls[j * 4];  // the lse2 of query rows 128 k + j * 8 + 2 tig, + 1
        best[0] = fmaxf(best[0], fmaxf(fmaf(st[j * 4 + 0], LOG2E, -lv.x),
                                       fmaf(st[j * 4 + 1], LOG2E, -lv.y)));
        best[1] = fmaxf(best[1], fmaxf(fmaf(st[j * 4 + 2], LOG2E, -lv.x),
                                       fmaf(st[j * 4 + 3], LOG2E, -lv.y)));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = kvz::quad_max(best[r]);
      const int w = key0 + 8 * r;  // window column of the thread's key row r
      if (tig == 0 && w < ctx_len) {
        const float p = sm90::ex2(v);
        if (p > 0.f) atomicMax(dst + w, __float_as_uint(p));
      }
    }
  }
}

}  // namespace

// q (T, H, D) bf16; keys (Hkv, K, D) bf16, K = sink + s_ctx + T; both
// 16-byte aligned; out (Hkv, s_ctx) f32, zeroed here; nq queries a CTA
// (nq G <= 256, nq <= 256), 0 < ctx_len <= s_ctx, 0 < q_valid <= T.
// Returns a CUDA error code (cudaErrorInvalidValue when a tensor map cannot
// be made or an argument is out of range).
extern "C" int kvz_fused_scores(const void* q, const void* keys, void* out, int T, int H,
                                int Hkv, int K, int sink, int s_ctx, int ctx_len, int q_valid,
                                int nq, float scale, void* stream) {
  static bool attr = false;
  if (!attr) {
    for (const void* k : {reinterpret_cast<const void*>(score_kernel<1>),
                          reinterpret_cast<const void*>(score_kernel<2>)}) {
      cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    attr = true;
  }
  const int G = H / Hkv;
  if (nq < 1 || nq > 256 || nq * G > ROWS || ctx_len < 1 || ctx_len > s_ctx || q_valid < 1 ||
      q_valid > T || K != sink + s_ctx + T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * Hkv * s_ctx, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qmap, kmap;
  const cuuint64_t qdims[3] = {D, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T)};
  const cuuint64_t qstrides[2] = {D * 2, static_cast<cuuint64_t>(H) * D * 2};
  const cuuint32_t qbox[3] = {64, static_cast<cuuint32_t>(G), static_cast<cuuint32_t>(nq)};
  const cuuint64_t kdims[3] = {D, static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(Hkv)};
  const cuuint64_t kstrides[2] = {D * 2, static_cast<cuuint64_t>(K) * D * 2};
  const cuuint32_t kbox[3] = {64, BKT, 1};
  if (!sm90::bf16_map(&qmap, q, 3, qdims, qstrides, qbox) ||
      !sm90::bf16_map(&kmap, keys, 3, kdims, kstrides, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Hkv, (q_valid + nq - 1) / nq);
  const int rtw = ((nq * G + 63) / 64 + CWG - 1) / CWG;  // row tiles a consumer warpgroup
  auto go = [&](auto kern) {
    kern<<<grid, NTHR, SMEM, st>>>(qmap, kmap, static_cast<float*>(out), T, G, nq, sink, s_ctx,
                                   ctx_len, q_valid, scale);
  };
  if (rtw == 1)
    go(score_kernel<1>);
  else
    go(score_kernel<2>);
  return static_cast<int>(cudaGetLastError());
}
