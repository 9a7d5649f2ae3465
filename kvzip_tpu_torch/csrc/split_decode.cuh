// The one-launch decode body of K4 (ragged_decode.cu, bf16 rows) and of
// K5's decode form (flash_int4.cu, int4 rows): T <= 16 new queries of each
// kv head against its dense cache rows [0, min(base_lens[h] + T, C)), the
// T new rows appended at base_lens[h] and causal among themselves (key j
// visible to query i iff j < base_lens[h] + i + 1).
//
// Design: the TPU kernels carried (m, l, acc) in scratch across a
// sequential key axis. Here the grid is sized to the card, not to the
// cache: (row groups, S splits, kv heads) with S planned by the wrapper
// (ops/ragged_decode.py::plan_splits) so the grid is at most one CTA a SM,
// and each head's live rows cut on the device into S equal 16-key-aligned
// splits, so the split length follows the live length without a host read
// (the call stays graph-capturable). The GQA group and the T queries pack
// into rows (row r = query r % T of head r / T), 32 rows a CTA in one or
// two 16-row mma.sync tiles. Every warp computes: warp w takes the 16-key
// tiles w, w + 4, ... of its CTA's split through its own cp.async ring
// (Src::NST stages, all but one in flight while one is computed), and
// keeps its own fp32 online softmax (base 2, ex2.approx); only a tile that
// reaches past base is masked. The warps' (m, l, acc) merge in shared
// memory into one partial a CTA, which it counts with a release reduction
// on its (kv head, row group)'s count. The group's first 8 splits then
// merge, once the count is complete, a 16-column slice each: the partials
// are laid out so that a slice of every split is one contiguous run, which
// one TMA bulk copy stages, and the (m, l) rows another. No second kernel,
// and no CTA reads more than an eighth of the partials.
//
// The row source is a template parameter:
// - Bf16Src (K4): a stage is 16 K and 16 V rows (SROW-padded); K and Q
//   fragments by ldmatrix, V's by ldmatrix.trans.
// - Int4Src (K5's decode form): a stage is 16 packed K and V rows (64 bytes
//   each) and the 4-byte words holding their bf16 scales and zeros. Keys
//   stay nibbles: B fragments are built in registers from one 16-byte read
//   of a key row (the D dimension permuted alike in Q's shared rows, as
//   int4_decode.cuh's exact mode does), and the quant algebra is folded out
//   of q.k in float32 (q.x = scale (q.n) + zero sum(q)). V is dequantized
//   once a stage into the warp's bf16 tile (n * scale + zero, rounded
//   once), read by ldmatrix.trans as K4 reads its V.
#pragma once

#include "attn_common.cuh"
#include "sm90.cuh"

namespace sdec {

using namespace kvz;

constexpr int NW = 4;                            // warps a CTA
constexpr int KW = 16;                           // keys a warp tile
constexpr int RG = 32;                           // packed rows a CTA
constexpr int NBLK = D / 16;                     // 16-column blocks: 8 merging CTAs at most
constexpr int ALIGN = KW;                        // split granularity (keys)
// The rings, then (reused) the warps' merge and the merging CTAs' staging:
// K4's four stages of 16 bf16 K and V rows a warp.
constexpr int REGION = NW * 4 * (2 * KW * SROW * 2);
constexpr int SMEM_BYTES = RG * SROW * 2 + REGION;

__device__ __forceinline__ int merge_ctas(int S) {
  return S >= NBLK ? NBLK : (S >= 4 ? 4 : (S >= 2 ? 2 : 1));
}

// ------------------------------------------------------------ bf16 rows
struct Bf16Src {
  struct Args {
    const bf16* k;  // (Hkv, C, D)
    const bf16* v;
  };
  static constexpr int NST = 4;
  static constexpr int STAGE = 2 * KW * SROW * 2;  // bytes: K then V rows
  static constexpr int WORK = 0;                   // a warp's bytes beside its ring
  static constexpr bool PERMUTE_Q = false;
  const bf16 *kh, *vh;

  __device__ Bf16Src(const Args& a, int hk, int C)
      : kh(a.k + static_cast<size_t>(hk) * C * D), vh(a.v + static_cast<size_t>(hk) * C * D) {}

  // keys [c0, c0 + KW) into the stage; rows past k1 zero
  __device__ __forceinline__ void load(uint8_t* stage, int c0, int k1, int lane) const {
    bf16* Ks = reinterpret_cast<bf16*>(stage);
    bf16* Vs = Ks + KW * SROW;
#pragma unroll
    for (int j = lane; j < KW * (D / 8); j += 32) {
      const int r = j >> 4, c = (j & 15) * 8;
      const bool ok = c0 + r < k1;
      const size_t off = ok ? static_cast<size_t>(c0 + r) * D + c : 0;
      cp_async16(Ks + r * SROW + c, kh + off, ok);
      cp_async16(Vs + r * SROW + c, vh + off, ok);
    }
  }

  template <int MT>
  __device__ __forceinline__ void prepare(const bf16*, int) {}

  // s = q . k^T (natural units) for the tile's 16 keys; returns its V rows
  template <int MT>
  __device__ __forceinline__ const bf16* scores(float (&s)[MT][2][4], const bf16* Qs,
                                                const uint8_t* stage, uint8_t*, int lane,
                                                int) const {
    const bf16* Ks = reinterpret_cast<const bf16*>(stage);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
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
    return Ks + KW * SROW;
  }
};

// ------------------------------------------------------------ int4 rows
struct Int4Src {
  struct Args {
    const uint8_t* kq;  // (Hkv, C, D/2) split-packed
    const bf16* ks;     // (Hkv, C)
    const bf16* kz;
    const uint8_t* vq;
    const bf16* vs;
    const bf16* vz;
    int Hkv;
  };
  static constexpr int DP = D / 2;
  static constexpr int NST = 6;
  // a stage: packed K rows, packed V rows, then for each of k scale, k
  // zero, v scale, v zero the 9 aligned 4-byte words that hold its 16 rows
  static constexpr int OFF_V = KW * DP;
  static constexpr int OFF_SC = 2 * KW * DP;
  static constexpr int SCW = 9;  // words an array
  static constexpr int STAGE = (OFF_SC + 4 * SCW * 4 + 15) / 16 * 16;
  static constexpr int WORK = KW * SROW * 2;  // the warp's dequantized V tile
  static constexpr bool PERMUTE_Q = true;
  const uint8_t *kq, *vq;
  const bf16 *ks, *kz, *vs, *vz;
  size_t row0, total;  // the head's first scale element; elements an array
  float qs[2][2];      // sum(q) of the lane's rows [mt][lo | hi]

  __device__ Int4Src(const Args& a, int hk, int C)
      : kq(a.kq + static_cast<size_t>(hk) * C * DP),
        vq(a.vq + static_cast<size_t>(hk) * C * DP),
        ks(a.ks),
        kz(a.kz),
        vs(a.vs),
        vz(a.vz),
        row0(static_cast<size_t>(hk) * C),
        total(static_cast<size_t>(a.Hkv) * C) {}

  __device__ __forceinline__ void load(uint8_t* stage, int c0, int k1, int lane) const {
#pragma unroll
    for (int j = lane; j < 2 * KW * (DP / 16); j += 32) {  // 64 chunks of K, then 64 of V
      const int r = (j >> 2) & (KW - 1), c = (j & 3) * 16, isv = j >= KW * (DP / 16);
      const bool ok = c0 + r < k1;
      const size_t off = ok ? static_cast<size_t>(c0 + r) * DP + c : 0;
      cp_async16(stage + isv * OFF_V + r * DP + c, (isv ? vq : kq) + off, ok);
    }
    // word w of array a holds elements 2 (e0 / 2 + w) and + 1, e0 = the
    // tile's first row; words past the tile's live rows are zero, and the
    // array's last element alone (an odd count) is copied by hand
    const size_t e0 = row0 + c0, e1 = row0 + min(c0 + KW, k1);
    for (int j = lane; j < 4 * SCW; j += 32) {
      const int a = j < 32 ? j >> 3 : j - 32, w = j < 32 ? j & 7 : 8;
      const bf16* arr = a == 0 ? ks : a == 1 ? kz : a == 2 ? vs : vz;  // no indexed array
      const size_t e = (e0 & ~static_cast<size_t>(1)) + 2 * w;
      uint8_t* dst = stage + OFF_SC + (a * SCW + w) * 4;
      if (e + 1 < total || e >= e1) {
        const bool ok = e < e1;
        const unsigned s = sm90::smem_u32(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                     "l"(ok ? arr + e : arr), "r"(ok ? 4 : 0));
      } else {
        const bf16 x = arr[e];
        *reinterpret_cast<uint32_t*>(dst) = static_cast<uint32_t>(__bfloat16_as_ushort(x));
      }
    }
  }

  // sum(q) of the lane's rows, from the CTA's (permuted) shared rows
  template <int MT>
  __device__ __forceinline__ void prepare(const bf16* Qs, int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* row = Qs + (mt * 16 + gid + 8 * i) * SROW + tig * 32;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < 32; c += 2) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
          acc += f.x + f.y;
        }
        qs[mt][i] = quad_sum(acc);
      }
  }

  // element r (0..15) of array a of the stage
  __device__ __forceinline__ float scale_of(const uint8_t* stage, int a, int r, int odd) const {
    return __bfloat162float(
        reinterpret_cast<const bf16*>(stage + OFF_SC + a * SCW * 4)[odd + r]);
  }

  template <int MT>
  __device__ __forceinline__ const bf16* scores(float (&s)[MT][2][4], const bf16* Qs,
                                                const uint8_t* stage, uint8_t* work, int lane,
                                                int c0) const {
    const int gid = lane >> 2, tig = lane & 3, odd = static_cast<int>((row0 + c0) & 1);
    bf16* vb = reinterpret_cast<bf16*>(work);
    // V: lane (row lane / 2, byte half lane % 2) dequantizes 32 packed
    // bytes into columns h 32 + j (high nibbles) and 64 + h 32 + j (low)
    {
      const int r = lane >> 1, h = lane & 1;
      const float vsc = scale_of(stage, 2, r, odd), vz = scale_of(stage, 3, r, odd);
      const uint4* src = reinterpret_cast<const uint4*>(stage + OFF_V + r * DP + h * 32);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint4 w4 = src[u];
        const uint32_t ws[4] = {w4.x, w4.y, w4.z, w4.w};
        uint32_t hi[8], lo[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t hn = (ws[k] >> 4) & 0x0f0f0f0fu, ln = ws[k] & 0x0f0f0f0fu;
          hi[2 * k] = pack_f32(fmaf(nib(hn, 0), vsc, vz), fmaf(nib(hn, 1), vsc, vz));
          hi[2 * k + 1] = pack_f32(fmaf(nib(hn, 2), vsc, vz), fmaf(nib(hn, 3), vsc, vz));
          lo[2 * k] = pack_f32(fmaf(nib(ln, 0), vsc, vz), fmaf(nib(ln, 1), vsc, vz));
          lo[2 * k + 1] = pack_f32(fmaf(nib(ln, 2), vsc, vz), fmaf(nib(ln, 3), vsc, vz));
        }
        bf16* dh = vb + r * SROW + h * 32 + u * 16;
        *reinterpret_cast<uint4*>(dh) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(dh + 8) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
        *reinterpret_cast<uint4*>(dh + DP) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(dh + DP + 8) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      }
    }
    // q.n: lane reads bytes tig 16 .. + 15 of key rows gid and 8 + gid;
    // step kk < 4 takes their high nibbles, kk >= 4 the low ones, against
    // Q's columns permuted to match (the CTA stores Q so)
    uint32_t b[2][KK_D][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint4 kw = *reinterpret_cast<const uint4*>(stage + (nt * 8 + gid) * DP + tig * 16);
      const uint32_t ws[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t p01 = __byte_perm(ws[kk], 0u, 0x4140), p23 = __byte_perm(ws[kk], 0u, 0x4342);
        b[nt][kk][0] = nib_bf16x2(p01 >> 4);
        b[nt][kk][1] = nib_bf16x2(p23 >> 4);
        b[nt][kk + 4][0] = nib_bf16x2(p01);
        b[nt][kk + 4][1] = nib_bf16x2(p23);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK_D; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        sm90::ldsm_x4(a, Qs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + kk * 16 +
                             (lane >> 4) * 8);
        mma16816(s[mt][0], a, b[0][kk][0], b[0][kk][1]);
        mma16816(s[mt][1], a, b[1][kk][0], b[1][kk][1]);
      }
    // fold: q.x = scale (q.n) + zero sum(q)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + tig * 2 + e;
        const float sk = scale_of(stage, 0, col, odd), zk = scale_of(stage, 1, col, odd);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[mt][nt][e] = fmaf(s[mt][nt][e], sk, qs[mt][0] * zk);
          s[mt][nt][e + 2] = fmaf(s[mt][nt][e + 2], sk, qs[mt][1] * zk);
        }
      }
    __syncwarp();  // the V tile is written
    return vb;
  }

  // byte k of w (a nibble) as a float, through the float 2^23 + n
  static __device__ __forceinline__ float nib(uint32_t w, int k) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + k)) - 8388608.f;
  }

  // bf16x2 of the nibbles in bits 0-3 and 16-19 of x: 0x4300 | n is the
  // bf16 128 + n, exactly; minus 128 leaves n
  static __device__ __forceinline__ uint32_t nib_bf16x2(uint32_t x) {
    const uint32_t y = (x & 0x000f000fu) | 0x43004300u;
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y),
                                     __floats2bfloat162_rn(128.f, 128.f));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// The physical column of shared Q row element `c` for a source whose keys
// come permuted (Int4Src): the A fragment of step kk = p / 16 must hold, at
// lane tig, logical columns (kk / 4) 64 + tig 16 + (kk % 4) 4 + {0, 1}
// (register 0) and + {2, 3} (register 2). Inverse: logical column of
// physical p.
__device__ __forceinline__ int permuted_col(int p) {
  const int kk = p >> 4, half = (p >> 3) & 1, tig = (p >> 1) & 3, e = p & 1;
  return (kk >> 2) * 64 + tig * 16 + (kk & 3) * 4 + half * 2 + e;
}

template <class Src, int MT>
__global__ void __launch_bounds__(NW * 32, 1)
    split_decode_kernel(const bf16* __restrict__ q, const typename Src::Args args,
                        const int* __restrict__ base_lens, bf16* __restrict__ out,
                        float* part_acc, float* part_ml, int* tickets, int T, int H, int C,
                        int G, int S, float scale_log2) {
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

  Src src(args, hk, C);
  const int ntiles = (k1 - k0 + KW - 1) / KW;
  const int mine = ntiles > warp ? (ntiles - warp + NW - 1) / NW : 0;
  uint8_t* wring = ring + warp * (Src::NST * Src::STAGE + Src::WORK);
  uint8_t* work = wring + Src::NST * Src::STAGE;

#pragma unroll
  for (int i = 0; i < Src::NST - 1; ++i) {
    if (i < mine) src.load(wring + i * Src::STAGE, k0 + (warp + i * NW) * KW, k1, lane);
    sm90::cp_async_commit();
  }

  // the CTA's query rows, zero past nrows, while the first tiles load
  if (Src::PERMUTE_Q) {
    for (int i = tid; i < MT * 16 * (D / 2); i += NW * 32) {  // a bf16 pair a thread
      const int r = i / (D / 2), p = (i % (D / 2)) * 2;
      uint32_t val = 0u;
      if (r < nrows) {
        const int gr = r0 + r;
        val = ld32(q + (static_cast<size_t>(gr % T) * H + hk * G + gr / T) * D +
                   permuted_col(p));
      }
      *reinterpret_cast<uint32_t*>(Qs + r * SROW + p) = val;
    }
  } else {
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
  }
  __syncthreads();
  src.template prepare<MT>(Qs, lane);
  for (int i = 0; i < mine; ++i) {
    const int c0 = k0 + (warp + i * NW) * KW;
    if (i + Src::NST - 1 < mine)
      src.load(wring + ((i + Src::NST - 1) % Src::NST) * Src::STAGE,
               k0 + (warp + (i + Src::NST - 1) * NW) * KW, k1, lane);
    sm90::cp_async_commit();
    sm90::cp_async_wait<Src::NST - 1>();
    __syncwarp();
    const uint8_t* stage = wring + (i % Src::NST) * Src::STAGE;

    float s[MT][2][4];
    const bf16* Vs = src.template scores<MT>(s, Qs, stage, work, lane, c0);

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
  const int MC = merge_ctas(S);
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

// Launches split_decode_kernel<Src>: q (T, H, D) bf16; base_lens (Hkv,)
// int32; out (T, H, D); part_acc Hkv * RGS * S * 32 * D and part_ml
// Hkv * RGS * 32 * S * 2 + 4 f32 scratch (layouts in the kernel) with
// RGS = ceil(G * T / 32); tickets (Hkv * RGS,) int32, zero before the
// first launch (each launch leaves them zero). The grid (RGS, S, Hkv) must
// fit the card at once (merging CTAs wait for the rest of their group) and
// a merging CTA's staging its shared memory: the wrapper plans both
// (ops/ragged_decode.py::plan_splits). `static`: each library keeps its own
// record of the shared-memory attribute it has set.
template <class Src>
static int launch(const void* q, const typename Src::Args& args, const void* base_lens,
                  void* out, void* part_acc, void* part_ml, void* tickets, int T, int H, int Hkv,
                  int C, int S, float scale, void* stream) {
  static bool attr[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr[dev]) {
    cudaError_t e = cudaFuncSetAttribute(split_decode_kernel<Src, 1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(split_decode_kernel<Src, 2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr[dev] = true;
  }
  const int G = H / Hkv, R = G * T, nr = min(R, RG);
  const int MC = S >= NBLK ? NBLK : (S >= 4 ? 4 : (S >= 2 ? 2 : 1));
  if (S < 1 || (nr * S * 2 + 3) / 4 * 4 + (nr * S + 3) / 4 * 4 + NBLK / MC * S * nr * 16 >
                   REGION / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((R + RG - 1) / RG, S, Hkv);
  const float sl2 = scale * 1.4426950408889634f;
  auto go = [&](auto kern) {
    kern<<<grid, NW * 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), args, static_cast<const int*>(base_lens),
        static_cast<bf16*>(out), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
        static_cast<int*>(tickets), T, H, C, G, S, sl2);
  };
  if (R > 16)
    go(split_decode_kernel<Src, 2>);
  else
    go(split_decode_kernel<Src, 1>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sdec
