// The Hopper flash-attention body shared by K1 (flash.cu), K9
// (windowed_attend.cu) and the int4 prefill/scoring kernel of K5/K6
// (flash_int4.cu): a CTA per (query head, block of BQ = 128 queries), a
// producer warpgroup feeding 128-key tiles through a two-stage shared-memory
// ring, two consumer warpgroups of 64 query rows each running
// wgmma.m64n128k16 for q.k (both operands in shared memory) and p.v (P in
// registers, V the MN-major B operand), the online softmax in base 2 in
// registers.
//
// Which key tiles a block visits, which of them need a mask and which
// (column, row) pairs are visible is a Plan (flash.cu's CausalPlan,
// windowed_attend.cu's WindowPlan). The producer and the consumers walk the
// same list, "the i-th live tile" (Plan::tile), so stage index and barrier
// phase count live tiles on both sides; a tile that no row sees is never
// loaded.
#pragma once

#include "attn_common.cuh"
#include "sm90.cuh"

namespace fsm90 {

using kvz::bf16;
using kvz::D;

constexpr int BQ = 128;             // queries a CTA
constexpr int BKT = 128;            // keys a tile
constexpr int STAGES = 2;
constexpr int HALF = BKT * 64 * 2;  // one 64-column box of a bf16 tile, bytes
constexpr int TILE = 2 * HALF;      // a 128 x 128 bf16 tile
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// sc = Q K^T for the consumer's 64 rows: Q's two 64-column boxes (qd0,
// qd1) against the K tile at ks (two boxes HALF bytes apart, as TMA writes
// them with the 128-byte swizzle).
__device__ __forceinline__ void qk_tile(float (&sc)[64], uint64_t qd0, uint64_t qd1,
                                        const uint8_t* ks) {
  const uint64_t kd0 = sm90::desc_sw128(ks, 0, 1024), kd1 = sm90::desc_sw128(ks + HALF, 0, 1024);
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
}

// o += P V: 16 keys a step; V's 8-key groups are 1,024 bytes apart, its two
// 64-column boxes HALF bytes apart.
__device__ __forceinline__ void pv_tile(float (&o)[64], const uint32_t (&pa)[8][4],
                                        const uint8_t* vs) {
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
}

// Masks the scores of one tile: sc[j*4 + e] is (row lo | hi, column
// col0 + j*8 + 2*tig + (e & 1)).
template <class Plan>
__device__ __forceinline__ void mask_tile(float (&sc)[64], const Plan& plan, int col0, int tig,
                                          int row_lo, int row_hi) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + j * 8 + tig * 2;
    if (!plan.visible(col, row_lo)) sc[j * 4 + 0] = -INFINITY;
    if (!plan.visible(col + 1, row_lo)) sc[j * 4 + 1] = -INFINITY;
    if (!plan.visible(col, row_hi)) sc[j * 4 + 2] = -INFINITY;
    if (!plan.visible(col + 1, row_hi)) sc[j * 4 + 3] = -INFINITY;
  }
}

// One online-softmax step of the thread's two rows: the running maxima m
// (base 2) and lane-partial denominators l are updated, o is rescaled, and
// sc is overwritten with p = 2^(sc * scale_log2 - max); alpha returns the
// rescale factor of each row.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&o)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[j * 4 + 0], sc[j * 4 + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[j * 4 + 2], sc[j * 4 + 3]));
  }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], kvz::quad_max(mx[i]) * scale_log2);
    mu[i] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet keeps p = 0
    alpha[i] = sm90::ex2(m[i] - mu[i]);
    m[i] = mn;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j * 4 + e] = sm90::ex2(fmaf(sc[j * 4 + e], scale_log2, -mu[e >> 1]));
      l[e >> 1] += sc[j * 4 + e];
      o[j * 4 + e] *= alpha[e >> 1];
    }
  }
}

// Writes the thread's two rows (o + extra) / sum(l) of query head h as
// bf16; rows at or past T are not stored.
__device__ __forceinline__ void store_rows(const float (&o)[64], const float (&l)[2],
                                           const float (&extra)[2], bf16* __restrict__ out,
                                           int row_lo, int row_hi, int T, int H, int h,
                                           int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row_hi : row_lo;
    const float den = fmaxf(kvz::quad_sum(l[i]), 1e-37f);
    if (row >= T) continue;
    bf16* dst = out + (static_cast<size_t>(row) * H + h) * D + tig * 2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          (o[j * 4 + 2 * i] + extra[i]) / den, (o[j * 4 + 2 * i + 1] + extra[i]) / den);
  }
}

// Shared memory of the bf16 kernel: Q, then the K/V ring, then barriers.
constexpr int Q_OFF = 0;
constexpr int K_OFF = TILE;  // K[s] at K_OFF + s * 2 * TILE, V[s] TILE after it
constexpr int BAR_OFF = TILE + STAGES * 2 * TILE;
constexpr int SMEM_BYTES = BAR_OFF + 64 + 1024;  // barriers, 1 KB alignment slack

// Attention of query head blockIdx.x, queries from (gridDim.y - 1 -
// blockIdx.y) * BQ (heaviest blocks first), over the bf16 keys and values
// of tensor maps kmap/vmap (dims D, keys, kv heads; box 64 x BKT x 1) and
// q of qmap (dims H * D, T; box 64 x BQ). Plan(args, hk, q0, T) names the
// live tiles.
template <class Plan>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const typename Plan::Args args,
                      bf16* __restrict__ out, int T, int H, int G, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full_k = bars;              // [STAGES]
  uint64_t* full_v = bars + STAGES;     // [STAGES]
  uint64_t* empty = bars + 2 * STAGES;  // [STAGES]
  uint64_t* q_full = bars + 3 * STAGES;

  const int h = blockIdx.x, hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const Plan plan(args, hk, q0, T);
  const int n_live = plan.live();

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
      for (int i = 0; i < n_live; ++i) {
        const int s = i % STAGES, k0 = plan.tile(i) * BKT;
        if (i >= STAGES) sm90::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        uint8_t* ks = smem + K_OFF + s * 2 * TILE;
        uint8_t* vs = ks + TILE;
        sm90::mbar_expect_tx(&full_k[s], TILE);
        sm90::tma_load_3d(ks, &kmap, &full_k[s], 0, k0, hk);
        sm90::tma_load_3d(ks + HALF, &kmap, &full_k[s], 64, k0, hk);
        sm90::mbar_expect_tx(&full_v[s], TILE);
        sm90::tma_load_3d(vs, &vmap, &full_v[s], 0, k0, hk);
        sm90::tma_load_3d(vs + HALF, &vmap, &full_v[s], 64, k0, hk);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  sm90::regs_alloc<232>();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + c * 64 + (tid >> 5) * 16 + gid, row_hi = row_lo + 8;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // Q rows c*64.. of both 64-column boxes (8 KB into each)
  const uint64_t qd0 = sm90::desc_sw128(smem + Q_OFF + c * 64 * 128, 0, 1024);
  const uint64_t qd1 = sm90::desc_sw128(smem + Q_OFF + HALF + c * 64 * 128, 0, 1024);
  sm90::mbar_wait(q_full, 0);

  for (int i = 0; i < n_live; ++i) {
    const int s = i % STAGES, t = plan.tile(i);
    const uint32_t ph = (i / STAGES) & 1;
    uint8_t* ks = smem + K_OFF + s * 2 * TILE;
    uint8_t* vs = ks + TILE;

    float sc[64];
    sm90::mbar_wait(&full_k[s], ph);
    qk_tile(sc, qd0, qd1, ks);
    if (!plan.full(t)) mask_tile(sc, plan, t * BKT, tig, row_lo, row_hi);

    float alpha[2];
    softmax_tile(sc, o, m, l, alpha, scale_log2);
    uint32_t pa[8][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pa[j >> 1][(j & 1) * 2 + 0] = kvz::pack_f32(sc[j * 4 + 0], sc[j * 4 + 1]);
      pa[j >> 1][(j & 1) * 2 + 1] = kvz::pack_f32(sc[j * 4 + 2], sc[j * 4 + 3]);
    }

    sm90::mbar_wait(&full_v[s], ph);
    pv_tile(o, pa, vs);
    sm90::mbar_arrive(&empty[s]);
  }

  const float none[2] = {0.f, 0.f};
  store_rows(o, l, none, out, row_lo, row_hi, T, H, h, tig);
}

// Encodes the tensor maps of q (T, H, D) and k/v (Hkv, K, D) bf16 and
// launches flash_bf16_kernel<Plan>. Returns a CUDA error code
// (cudaErrorInvalidValue when a tensor map cannot be made).
template <class Plan>
int launch_bf16(const void* q, const void* k, const void* v, const typename Plan::Args& args,
                void* out, int T, int H, int Hkv, int K, float scale, void* stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(flash_bf16_kernel<Plan>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  CUtensorMap qmap, kmap, vmap;
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(H) * D, static_cast<cuuint64_t>(T)};
  const cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(H) * D * 2};
  const cuuint32_t qbox[2] = {64, BQ};
  const cuuint64_t kdims[3] = {D, static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(Hkv)};
  const cuuint64_t kstrides[2] = {D * 2, static_cast<cuuint64_t>(K) * D * 2};
  const cuuint32_t kbox[3] = {64, BKT, 1};
  if (!sm90::bf16_map(&qmap, q, 2, qdims, qstrides, qbox) ||
      !sm90::bf16_map(&kmap, k, 3, kdims, kstrides, kbox) ||
      !sm90::bf16_map(&vmap, v, 3, kdims, kstrides, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(H, (T + BQ - 1) / BQ);
  flash_bf16_kernel<Plan><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, args, static_cast<bf16*>(out), T, H, H / Hkv, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fsm90
