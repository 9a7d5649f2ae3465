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
// Design (Hopper's producer/consumer shape): one CTA per (query head, block of
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
#include "attn_common.cuh"
#include "sm90.cuh"

using namespace kvz;

namespace {

constexpr int BQ = 128;                        // queries a CTA
constexpr int BKT = 128;                       // keys a tile
constexpr int STAGES = 2;
constexpr int HALF = BKT * 64 * 2;             // one 64-column box of a tile, bytes
constexpr int TILE = 2 * HALF;                 // a 128 x 128 bf16 tile
constexpr int Q_OFF = 0;
constexpr int K_OFF = TILE;                    // K[s] at K_OFF + s * 2 * TILE
constexpr int BAR_OFF = TILE + STAGES * 2 * TILE;
constexpr int SMEM_BYTES = BAR_OFF + 64 + 1024;  // barriers, 1 KB alignment slack
constexpr int THREADS = 384;

}  // namespace

__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const int* __restrict__ base_lens,
                       bf16* __restrict__ out, int T, int H, int C, int G, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full_k = bars;                 // [STAGES]
  uint64_t* full_v = bars + STAGES;        // [STAGES]
  uint64_t* empty = bars + 2 * STAGES;     // [STAGES]
  uint64_t* q_full = bars + 3 * STAGES;

  const int h = blockIdx.x, hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int base = base_lens[hk];
  const int kv_end = min(base + min(q0 + BQ, T), C);
  const int n_tiles = (kv_end + BKT - 1) / BKT;
  const int n_full = min(base + q0 + 1, C) / BKT;  // tiles every row of the block sees whole

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init(q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    sm90::regs_dealloc<40>();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_full, TILE);
      sm90::tma_load_2d(smem + Q_OFF, &qmap, q_full, h * D, q0);
      sm90::tma_load_2d(smem + Q_OFF + HALF, &qmap, q_full, h * D + 64, q0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) sm90::mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* ks = smem + K_OFF + s * 2 * TILE;
        uint8_t* vs = ks + TILE;
        sm90::mbar_expect_tx(&full_k[s], TILE);
        sm90::tma_load_3d(ks, &kmap, &full_k[s], 0, t * BKT, hk);
        sm90::tma_load_3d(ks + HALF, &kmap, &full_k[s], 64, t * BKT, hk);
        sm90::mbar_expect_tx(&full_v[s], TILE);
        sm90::tma_load_3d(vs, &vmap, &full_v[s], 0, t * BKT, hk);
        sm90::tma_load_3d(vs + HALF, &vmap, &full_v[s], 64, t * BKT, hk);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  sm90::regs_alloc<232>();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + c * 64 + (tid >> 5) * 16 + gid, row_hi = row_lo + 8;
  const int lim_lo = min(base + row_lo + 1, C), lim_hi = min(base + row_hi + 1, C);

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // Q rows c*64.. of both 64-column boxes (8 KB into each)
  const uint64_t qd0 = sm90::desc_sw128(smem + Q_OFF + c * 64 * 128, 0, 1024);
  const uint64_t qd1 = sm90::desc_sw128(smem + Q_OFF + HALF + c * 64 * 128, 0, 1024);
  sm90::mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    uint8_t* ks = smem + K_OFF + s * 2 * TILE;
    uint8_t* vs = ks + TILE;
    const uint64_t kd0 = sm90::desc_sw128(ks, 0, 1024), kd1 = sm90::desc_sw128(ks + HALF, 0, 1024);

    float sc[64];
    sm90::mbar_wait(&full_k[s], ph);
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // a 16-deep step is 32 bytes along the 128-byte swizzled row: +2 in
      // the descriptor's 16-byte address units
      const uint64_t adv = static_cast<uint64_t>((kk & 3) * 2);
      sm90::wgmma_m64n128k16_ss(sc, (kk < 4 ? qd0 : qd1) + adv, (kk < 4 ? kd0 : kd1) + adv, kk);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    if (t >= n_full) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = t * BKT + j * 8 + tig * 2;
        if (col >= lim_lo) sc[j * 4 + 0] = -INFINITY;
        if (col + 1 >= lim_lo) sc[j * 4 + 1] = -INFINITY;
        if (col >= lim_hi) sc[j * 4 + 2] = -INFINITY;
        if (col + 1 >= lim_hi) sc[j * 4 + 3] = -INFINITY;
      }
    }

    // online softmax in base 2; lane-partial denominators
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j * 4 + 0], sc[j * 4 + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j * 4 + 2], sc[j * 4 + 3]));
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
      mu[i] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet keeps p = 0
      alpha[i] = sm90::ex2(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= alpha[i];
    }
    uint32_t pa[8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = sm90::ex2(fmaf(sc[j * 4 + 0], scale_log2, -mu[0]));
      const float p1 = sm90::ex2(fmaf(sc[j * 4 + 1], scale_log2, -mu[0]));
      const float p2 = sm90::ex2(fmaf(sc[j * 4 + 2], scale_log2, -mu[1]));
      const float p3 = sm90::ex2(fmaf(sc[j * 4 + 3], scale_log2, -mu[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2 + 0] = pack_f32(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_f32(p2, p3);
      o[j * 4 + 0] *= alpha[0];
      o[j * 4 + 1] *= alpha[0];
      o[j * 4 + 2] *= alpha[1];
      o[j * 4 + 3] *= alpha[1];
    }

    // O += P V: 16 keys a step; V's 8-key groups are 1,024 bytes apart, its
    // two 64-column boxes HALF bytes apart
    sm90::mbar_wait(&full_v[s], ph);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t vd = sm90::desc_sw128(vs + kk * 16 * 128, HALF, 1024);
      sm90::wgmma_m64n128k16_rs_tb(o, pa[kk], vd);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row_hi : row_lo;
    const float den = fmaxf(quad_sum(l[i]), 1e-37f);
    if (row >= T) continue;
    bf16* dst = out + (static_cast<size_t>(row) * H + h) * D + tig * 2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j * 4 + 2 * i] / den, o[j * 4 + 2 * i + 1] / den);
  }
}

// q (T, H, D), k/v (Hkv, C, D) bf16, 16-byte aligned; base_lens (Hkv,) int32;
// out (T, H, D). Returns a CUDA error code (cudaErrorInvalidValue when a
// tensor map cannot be made).
extern "C" int kvz_flash_attend(const void* q, const void* k, const void* v,
                                const void* base_lens, void* out, int T, int H, int Hkv, int C,
                                float scale, void* stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  CUtensorMap qmap, kmap, vmap;
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(H) * D, static_cast<cuuint64_t>(T)};
  const cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(H) * D * 2};
  const cuuint32_t qbox[2] = {64, BQ};
  const cuuint64_t kdims[3] = {D, static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(Hkv)};
  const cuuint64_t kstrides[2] = {D * 2, static_cast<cuuint64_t>(C) * D * 2};
  const cuuint32_t kbox[3] = {64, BKT, 1};
  if (!sm90::bf16_map(&qmap, q, 2, qdims, qstrides, qbox) ||
      !sm90::bf16_map(&kmap, k, 3, kdims, kstrides, kbox) ||
      !sm90::bf16_map(&vmap, v, 3, kdims, kstrides, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  const float log2e = 1.4426950408889634f;
  dim3 grid(H, (T + BQ - 1) / BQ);
  flash_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<const int*>(base_lens), static_cast<bf16*>(out), T, H, C, G,
      scale * log2e);
  return static_cast<int>(cudaGetLastError());
}
