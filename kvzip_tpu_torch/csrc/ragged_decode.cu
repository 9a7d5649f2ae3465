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
// Design: the TPU kernel carried (m, l, acc) in scratch across a sequential
// key axis. Here the grid is sized to the card, not to the cache: (row
// groups, S splits, kv heads) with S planned by the wrapper so the grid is
// at most one CTA a SM (148 KB of shared memory each), and each head's
// live rows cut on the device into S equal 16-key-aligned splits, so the
// split length follows the live length without a host read. The GQA group
// and the T queries pack into rows (row r = query r % T of head r / T), 32
// rows a CTA in one or two 16-row mma.sync tiles. Every warp computes: warp
// w takes the 16-key tiles w, w + 4, ... of its CTA's split through its own
// four-stage cp.async ring (three tiles, 26 KB a warp, in flight while one
// is computed), reads K and V fragments with ldmatrix (.trans for V) and
// Q's from shared memory, and keeps its own fp32 online softmax (base 2,
// ex2.approx); only a tile that reaches past base is masked. The warps'
// (m, l, acc) merge in shared memory into one partial a CTA, which it
// counts with a release reduction on its (kv head, row group)'s count. The
// group's first 8 splits then merge, once the count is complete, a
// 16-column slice each: the partials are laid out so that a slice of every
// split is one contiguous run, which one TMA bulk copy stages, and the
// (m, l) rows another. No second kernel, and no CTA reads more than an
// eighth of the partials.
//
// Tried and measured (tools/k4_variants.py, NVIDIA H100 80GB HBM3, 700.00 W):
// the first version's merge kernel took 62% of 0.063 ms; the last CTA of a
// head merging all 33 partials took 7.5 us of 24 us (one SM's copies of 118 KB
// are slow, however issued: cp.async per thread or TMA); merging in 8-CTA
// clusters through distributed shared memory left clusters waiting for SMs
// (some of 16 started 16 us late); per-split ready flags polled with acquire
// loads, and copies issued by few threads, serialised. Deeper (6) or shallower
// (2) rings change nothing: the compute hides under the loads.
#include "attn_common.cuh"
#include "sm90.cuh"

using namespace kvz;

namespace {

constexpr int NW = 4;                            // warps a CTA
constexpr int KW = 16;                           // keys a warp tile
constexpr int NST = 4;                           // ring stages a warp
constexpr int RG = 32;                           // packed rows a CTA
constexpr int NBLK = D / 16;                     // 16-column blocks: 8 merging CTAs at most
constexpr int ALIGN = KW;                        // split granularity (keys)
constexpr int STAGE = 2 * KW * SROW;             // K and V tile, bf16 elements
constexpr int RING_BYTES = NW * NST * STAGE * 2;
constexpr int SMEM_BYTES = RG * SROW * 2 + RING_BYTES;

}  // namespace

template <int MT>
__global__ void __launch_bounds__(NW * 32, 1)
    ragged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ base_lens,
                  bf16* __restrict__ out, float* part_acc, float* part_ml, int* tickets,
                  int T, int H, int C, int G, int S, float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  uint8_t* ring = smem_raw + RG * SROW * 2;

  const int rg = blockIdx.x, split = blockIdx.y, hk = blockIdx.z, RGS = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int r0 = rg * RG, nrows = min(RG, G * T - r0);
  const size_t grp = static_cast<size_t>(hk) * RGS + rg;
  const int base = base_lens[hk];
  const int live = min(base + T, C);
  const int chunk = ((live + S - 1) / S + ALIGN - 1) / ALIGN * ALIGN;
  const int k0 = min(split * chunk, live), k1 = min(k0 + chunk, live);

  float acc[MT][NT_D][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  }

  const bf16* kh = k + static_cast<size_t>(hk) * C * D;
  const bf16* vh = v + static_cast<size_t>(hk) * C * D;
  const int ntiles = (k1 - k0 + KW - 1) / KW;
  const int mine = ntiles > warp ? (ntiles - warp + NW - 1) / NW : 0;
  bf16* wring = reinterpret_cast<bf16*>(ring) + warp * NST * STAGE;

  auto load = [&](int i) {  // the warp's i-th tile into stage i % NST; rows past k1 zero
    const int c0 = k0 + (warp + i * NW) * KW;
    bf16* Ks = wring + (i % NST) * STAGE;
    bf16* Vs = Ks + KW * SROW;
#pragma unroll
    for (int j = lane; j < KW * (D / 8); j += 32) {
      const int r = j >> 4, c = (j & 15) * 8;
      const bool ok = c0 + r < k1;
      const size_t off = ok ? static_cast<size_t>(c0 + r) * D + c : 0;
      cp_async16(Ks + r * SROW + c, kh + off, ok);
      cp_async16(Vs + r * SROW + c, vh + off, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < mine) load(i);
    sm90::cp_async_commit();
  }

  // the CTA's query rows, zero past nrows, while the first tiles load
  for (int i = tid; i < MT * 16 * (D / 8); i += NW * 32) {
    const int r = i >> 4, c = (i & 15) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      const int gr = r0 + r;
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(gr % T) * H + hk * G + gr / T) * D + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * SROW + c) = val;
  }
  __syncthreads();
  for (int i = 0; i < mine; ++i) {
    if (i + NST - 1 < mine) load(i + NST - 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<NST - 1>();
    __syncwarp();
    const int c0 = k0 + (warp + i * NW) * KW;
    const bf16* Ks = wring + (i % NST) * STAGE;
    const bf16* Vs = Ks + KW * SROW;

    // s = q . k^T: 16 keys as two 8-key tiles
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK_D; ++kk) {
      uint32_t b[4];
      sm90::ldsm_x4(b, Ks + ((lane >> 4) * 8 + (lane & 7)) * SROW + kk * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        sm90::ldsm_x4(a, Qs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + kk * 16 +
                             (lane >> 4) * 8);
        mma16816(s[mt][0], a, b[0], b[1]);
        mma16816(s[mt][1], a, b[2], b[3]);
      }
    }

    if (c0 + KW > min(base, live)) {  // the tile holding the T new rows (or the cache's end)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c0 + nt * 8 + tig * 2 + (j & 1);
            const int qi = (r0 + mt * 16 + gid + (j >> 1) * 8) % T;
            if (col >= min(base + qi + 1, live)) s[mt][nt][j] = -INFINITY;
          }
    }

    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float alpha[2], mu[2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const float mx = fmaxf(fmaxf(s[mt][0][2 * i2], s[mt][0][2 * i2 + 1]),
                               fmaxf(s[mt][1][2 * i2], s[mt][1][2 * i2 + 1]));
        const float mn = fmaxf(m[mt][i2], quad_max(mx) * scale_log2);
        mu[i2] = mn == -INFINITY ? 0.f : mn;
        alpha[i2] = sm90::ex2(m[mt][i2] - mu[i2]);
        m[mt][i2] = mn;
      }
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[nt][j] = sm90::ex2(fmaf(s[mt][nt][j], scale_log2, -mu[j >> 1]));
      l[mt][0] = l[mt][0] * alpha[0] + p[0][0] + p[0][1] + p[1][0] + p[1][1];
      l[mt][1] = l[mt][1] * alpha[1] + p[0][2] + p[0][3] + p[1][2] + p[1][3];
#pragma unroll
      for (int nt = 0; nt < NT_D; ++nt) {
        acc[mt][nt][0] *= alpha[0];
        acc[mt][nt][1] *= alpha[0];
        acc[mt][nt][2] *= alpha[1];
        acc[mt][nt][3] *= alpha[1];
      }
      pa[mt][0] = pack_f32(p[0][0], p[0][1]);
      pa[mt][1] = pack_f32(p[0][2], p[0][3]);
      pa[mt][2] = pack_f32(p[1][0], p[1][1]);
      pa[mt][3] = pack_f32(p[1][2], p[1][3]);
    }

    // acc += p . v: V fragments transposed by ldmatrix, two 8-wide tiles a load
#pragma unroll
    for (int np = 0; np < NT_D / 2; ++np) {
      uint32_t b[4];
      sm90::ldsm_x4_t(b, Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * SROW + np * 16 +
                             (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * np], pa[mt], b[0], b[1]);
        mma16816(acc[mt][2 * np + 1], pa[mt], b[2], b[3]);
      }
    }
    __syncwarp();
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it

  // merge the warps: red[w][row][D + 4] (the pad spreads a warp's stores
  // over the banks), rml[w][row] = (m, l)
  constexpr int RS = D + 4;
  float* red = reinterpret_cast<float*>(ring);
  float* rml = red + NW * RG * RS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = mt * 16 + gid + 8 * i2;
      const float lsum = quad_sum(l[mt][i2]);
      if (tig == 0) {
        rml[(warp * RG + row) * 2] = m[mt][i2];
        rml[(warp * RG + row) * 2 + 1] = lsum;
      }
      float* dst = red + (warp * RG + row) * RS + tig * 2;
#pragma unroll
      for (int nt = 0; nt < NT_D; ++nt)
        *reinterpret_cast<float2*>(dst + nt * 8) =
            make_float2(acc[mt][nt][2 * i2], acc[mt][nt][2 * i2 + 1]);
    }
  __syncthreads();

  // The CTA's partial, laid out for the merge: a group's values as
  // [16-column block][split][row][16] (a merging CTA's slice of every split
  // is one contiguous run), its (m, l) as [row][split][2]. Thread tid holds
  // column tid of every row.
  float* pacc = part_acc + grp * S * RG * D + (((tid >> 4) * S + split) * nrows) * 16 + (tid & 15);
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    if (r >= nrows) break;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, rml[(w * RG + r) * 2]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = sm90::ex2(rml[(w * RG + r) * 2] - M);
        L += f * rml[(w * RG + r) * 2 + 1];
        A += f * red[(w * RG + r) * RS + tid];
      }
    }
    pacc[r * 16] = A;
    if (tid == 0)
      *reinterpret_cast<float2*>(part_ml + ((grp * RG + r) * S + split) * 2) = make_float2(M, L);
  }

  // Publish: count the partial with a release reduction (the barrier
  // before it orders the whole CTA's partial before thread 0's release) and
  // leave; the group's first MC splits then merge it, a slice of 128 / MC
  // columns each, once the count reaches S (acquire). Each merger then adds
  // one more, and the one that brings the count to S + MC zeroes it for the
  // next launch: every merger has seen S by then.
  const int MC = S >= NBLK ? NBLK : (S >= 4 ? 4 : (S >= 2 ? 2 : 1));
  unsigned* count = reinterpret_cast<unsigned*>(tickets) + grp;
  __shared__ __align__(8) uint64_t s_bar[2];  // (m, l) rows; value blocks
  __syncthreads();
  if (split >= MC) {
    if (tid == 0) sm90::red_add_release(count, 1u);
    return;
  }
  if (tid == 0) {
    sm90::red_add_release(count, 1u);
    uint32_t polls = 0;
    while (static_cast<int>(sm90::ld_relaxed(count)) < S)
      if (++polls == (1u << 24)) __trap();  // a CTA that never arrives
    sm90::fence_acq_rel();
    sm90::fence_proxy_async();  // the partials are read by the TMA next
    sm90::mbar_init(&s_bar[0], 1);
    sm90::mbar_init(&s_bar[1], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int slot = split;

  // Stage with the TMA: the group's (m, l) rows and this slot's value
  // blocks of every split, one copy each on its own barrier; one warp a row
  // makes the weights while the values land, then thread (r, c) sums
  // column c of row r.
  const int bpm = NBLK / MC, W = 16 * bpm;           // blocks and columns a slot
  float* mls = reinterpret_cast<float*>(ring);      // [nrows][S][2]
  float* wts = mls + (nrows * S * 2 + 3) / 4 * 4;   // [nrows][S]
  float* buf = wts + (nrows * S + 3) / 4 * 4;       // [bpm][S][nrows][16]
  __shared__ float s_den[RG];
  unsigned reset_at = 0;
  if (tid == 0) {
    const uint32_t ml_bytes = (nrows * S * 8 + 15) / 16 * 16;
    const uint32_t val_bytes = bpm * S * nrows * 64;
    sm90::mbar_expect_tx(&s_bar[0], ml_bytes);
    sm90::bulk_load(mls, part_ml + grp * RG * S * 2, ml_bytes, &s_bar[0]);
    sm90::mbar_expect_tx(&s_bar[1], val_bytes);
    sm90::bulk_load(buf, part_acc + grp * S * RG * D + slot * bpm * S * nrows * 16, val_bytes,
                    &s_bar[1]);
    // one more on the count; its value is used at the end, after the sums
    reset_at = sm90::atom_add(count, 1u);
  }
  sm90::mbar_wait(&s_bar[0], 0);
  for (int r = warp; r < nrows; r += NW) {  // a warp a row, lanes over the splits
    const float* ml = mls + r * S * 2;
    float M = -INFINITY;
    for (int s = lane; s < S; s += 32) M = fmaxf(M, ml[s * 2]);
#pragma unroll
    for (int o = 16; o; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float w = M == -INFINITY ? 0.f : sm90::ex2(ml[s * 2] - M);
      wts[r * S + s] = w;
      L += w * ml[s * 2 + 1];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) s_den[r] = 1.f / fmaxf(L, 1e-37f);
  }
  __syncthreads();
  sm90::mbar_wait(&s_bar[1], 0);
  for (int i = tid; i < nrows * W; i += NW * 32) {
    const int r = i / W, c = i % W, off = ((c >> 4) * S * nrows + r) * 16 + (c & 15);
    const float* w = wts + r * S;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0;
    for (; s + 3 < S; s += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += w[s + u] * buf[(s + u) * nrows * 16 + off];
    }
    for (; s < S; ++s) a[0] += w[s] * buf[s * nrows * 16 + off];
    const int gr = r0 + r;
    out[(static_cast<size_t>(gr % T) * H + hk * G + gr / T) * D + slot * W + c] =
        __float2bfloat16_rn((a[0] + a[1] + a[2] + a[3]) * s_den[r]);
  }
  if (tid == 0 && reset_at == static_cast<unsigned>(S + MC - 1)) *count = 0u;
}

// q (T, H, D), k/v (Hkv, C, D) bf16; base_lens (Hkv,) int32; out (T, H, D);
// part_acc Hkv * RGS * S * 32 * D and part_ml Hkv * RGS * 32 * S * 2 + 4 f32
// scratch (layouts in the kernel) with RGS = ceil(G * T / 32); tickets
// (Hkv * RGS,) int32, zero before the first launch (each launch leaves them
// zero). The grid (RGS, S, Hkv) must fit the card at once (merging CTAs
// wait for the rest of their group) and a merging CTA's staging
// (S (3 32 + 32 128 / MC) floats at most) its shared memory: the wrapper
// plans both.
extern "C" int kvz_ragged_decode(const void* q, const void* k, const void* v,
                                 const void* base_lens, void* out, void* part_acc, void* part_ml,
                                 void* tickets, int T, int H, int Hkv, int C, int S, float scale,
                                 void* stream) {
  static bool attr[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr[dev]) {
    cudaError_t e = cudaFuncSetAttribute(ragged_kernel<1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ragged_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr[dev] = true;
  }
  const int G = H / Hkv, R = G * T, MC = S >= NBLK ? NBLK : (S >= 4 ? 4 : (S >= 2 ? 2 : 1));
  const int nr = min(R, RG);
  if (S < 1 || (nr * S * 2 + 3) / 4 * 4 + (nr * S + 3) / 4 * 4 + NBLK / MC * S * nr * 16 >
                   RING_BYTES / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((R + RG - 1) / RG, S, Hkv);
  const float sl2 = scale * 1.4426950408889634f;
  auto args = [&](auto kern) {
    kern<<<grid, NW * 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int*>(base_lens), static_cast<bf16*>(out),
        static_cast<float*>(part_acc), static_cast<float*>(part_ml), static_cast<int*>(tickets),
        T, H, C, G, S, sl2);
  };
  if (R > 16)
    args(ragged_kernel<2>);
  else
    args(ragged_kernel<1>);
  return static_cast<int>(cudaGetLastError());
}
