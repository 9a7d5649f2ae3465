// Shared body of the decode kernels K7 (int4 pool), K11 (int4 flat), K3
// (bf16 pool) and K10 (bf16 flat): one launch over one layer's segment of
// context rows and the bf16 tail of each kv head, with the flash-decoding
// merge inside the launch. Three modes: int4 rows exact (EXACT) or in the
// int8-attention mode (Q8), and bf16 rows (BF16, K3 and K10: no
// dequantization, 32-row items so that a key group's three stages of K and
// V rows fit beside the others').
//
// The segment: on the pool, the layer's rows [layer_off, + layer_rows); on
// the flat layout, sequence sb's R_seg rows of the layer, of which only the
// first seg_rows[layer][sb] are live (every flat build puts the kept rows
// first and pads the rest with row_head -1), so the items stop there and no
// padding tile is read; with no seg_rows every R_seg row is read and the
// padding masked.
//
// Exact mode: keys as nibbles with scale and zero folded out of q.k in
// float32 (q.x = scale (q.n) + zero sum(q)), values dequantized to bf16
// (bf16(n * scale + zero), rounded once).
//
// q8 mode (the reference's opt-in int8 attention, `_flat_int4_kernel` /
// `_pool_int4_kernel` with q8=True): split packing gives
//   q.n = q_hi . b + q_lo' . lo,  q_hi = q[:D/2] / 16,  q_lo' = q[D/2:] - q_hi,
// with b the packed byte and lo its low nibble. q_hi and q_lo' are quantized
// per row to s8 (scale amax / 127 + 1e-20, round half to even, IEEE
// division), and both products run as s8 x s8 -> s32 mma.sync on the raw
// bytes: b ^ 0x80 read as s8 is b - 128, so q.b = q.(b ^ 0x80) + 128 sum(q).
// The value side scales the probabilities instead of the values,
// ps = p * v_scale, quantizes ps per row over the tile's 64 keys
// (ps_s = max(ps) / 127 + 1e-20) and runs (ps / ps_s) . b and . lo as s8
// dots; sum p.v = ((ps.b - ps.lo) / 16, ps.lo) + sum p.v_zero. The int32
// sums are exact; p is quantized per 64-row tile aligned to the segment's
// row 0, which the plain version repeats.
//
// Schedule (bound: the layer's bytes; ~3 MB at the smoke's evicted pool):
// - Every query row of a sequence (all its kv heads x G x T, row r = query
//   r % T of head r / T of kv head r / (G T)) is a row of the CTA's 16-row
//   mma tiles, MTC of them in a row group (2, 4 or 8; 32 rows hold all 28
//   of qwen2.5-7b at T = 1). A key is scored against every row and masked
//   unless its row_head is the row's kv head, so each byte of the segment
//   is read once whatever the order of row_head; larger T takes more row
//   groups, each reading the segment again (from L2).
// - Work items: the segment's 64-row tiles (32 in BF16 mode), then 16-row
//   tiles of each kv head's tail (only the heads of the row group; a row
//   group of 16 MTC rows spans at most 16 MTC + 1 kv heads, so any number
//   of kv heads is taken). CTA `split` of S takes
//   items split, split + S, ... (interleaved, so a head-major pool's tiles
//   of one head do not fall to a few CTAs when T > 1 gives row groups of
//   one or two heads), and its KG = 8 / MTC key groups (MTC warps each,
//   one warp a 16-row tile) take every KG-th of those through a cp.async
//   ring: the group's warps load a stage together and meet at a named
//   barrier before computing it, while the next stages are in flight. A
//   warp skips the compute of a tile that holds no row of its heads.
// - Fragments come straight from the staged rows (bf16 rows: K by 16-byte
//   reads, V's B fragments by prmt of four rows' words): a lane reads 16
//   bytes of a key row for q.k (the D dimension permuted alike in q's
//   fragments). Exact mode dequantizes a stage's V once for the group into
//   a bf16 tile read by ldmatrix.trans; q8 reads 8 bytes of four key rows
//   and turns them into s8 B fragments with a 4x4 byte transpose (prmt),
//   so V stays row-major in shared memory. The output columns a lane holds
//   are permuted to match (columns n * 8 + j, j the 8-wide tile), and the
//   partials keep that order.
// - The key groups' (m, l, acc) merge in shared memory into one partial a
//   CTA, which the CTA publishes with a release reduction on its row
//   group's count; once the count reaches S, every CTA of the row group
//   merges an equal slice of the output (float4 columns of its rows, its
//   threads splitting the S partials). The grid (row groups, S, sequences)
//   is planned within the SM count, one CTA a SM (its shared memory), so
//   every CTA that waits shares the card with the ones it waits for.
//
// Measured (tools/int4_decode_variants.py, NVIDIA H100 80GB HBM3,
// 700.00 W, the smoke's evicted pool at T = 1): 0.0159 ms exact, 0.0161 q8
// (the PR 9 split and merge kernels: 0.0665, 0.1375); stamps: first stage
// landed 3.2 us, key loop done 7.6, partial published 9.6, count complete
// 11.9, output 14.5. The key loop is latency-bound (one 64-row tile a warp,
// two warps a scheduler): four independent mma chains and a V dequantized
// once a group instead of once a warp moved it by under 5%.
#pragma once

#include "int4_common.cuh"
#include "sm90.cuh"

namespace kvz {

using sm90::div_rn;
using sm90::mma_s8;

__device__ __forceinline__ int quad_sum_int(int x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The warp's two q rows (lo = gid, hi = gid + 8) quantized for the q8
// score product: s8 A fragments of m16n8k32 over the D/2 = 64 columns
// (qh of q_hi, ql of q_lo'), and per row the two scales, sum(qh8) and
// sum(q). A lane holds columns tig * 16 + e, e = kk * 8 + half * 4 + j,
// the bytes its key-row read gives (D permuted alike on both sides), made
// from the raw bf16 words fetched before the key loads were issued.
struct Q8Rows {
  uint32_t qh[2][4], ql[2][4];
  float qh_s[2], ql_s[2], bsum[2], qsum[2];

  // raw[i]: row i's columns tig * 16 ... + 15 (words 0, 1) and D/2 + the
  // same (words 2, 3), eight bf16 a word; zero for a missing row
  __device__ __forceinline__ void make(const uint4 raw[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float xh[16], xl[16], amax_h = 0.f, amax_l = 0.f, sum = 0.f;
      const bf16* hi = reinterpret_cast<const bf16*>(&raw[i][0]);
      const bf16* lo = reinterpret_cast<const bf16*>(&raw[i][2]);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float a = __bfloat162float(hi[e]), b = __bfloat162float(lo[e]);
        xh[e] = a * 0.0625f;
        xl[e] = b - xh[e];
        amax_h = fmaxf(amax_h, fabsf(xh[e]));
        amax_l = fmaxf(amax_l, fabsf(xl[e]));
        sum += a + b;
      }
      qh_s[i] = quad_max(amax_h) / 127.f + 1e-20f;
      ql_s[i] = quad_max(amax_l) / 127.f + 1e-20f;
      qsum[i] = quad_sum(sum);
      const float rh = 1.f / qh_s[i], rl = 1.f / ql_s[i];
      int bs = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // register r: kk = r >> 1, half = r & 1
        uint32_t wh = 0u, wl = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int e = r * 4 + j;
          int vh = static_cast<int>(rintf(div_rn(xh[e], qh_s[i], rh)));
          int vl = static_cast<int>(rintf(div_rn(xl[e], ql_s[i], rl)));
          bs += vh;
          wh |= (static_cast<uint32_t>(vh) & 0xffu) << (8 * j);
          wl |= (static_cast<uint32_t>(vl) & 0xffu) << (8 * j);
        }
        // A fragment: reg 0 = row lo, k tig*4..; 1 = row hi; 2, 3 = k + 16
        qh[r >> 1][(r & 1) * 2 + i] = wh;
        ql[r >> 1][(r & 1) * 2 + i] = wl;
      }
      bsum[i] = static_cast<float>(quad_sum_int(bs));
    }
  }
};

namespace i4d {

constexpr int NW = 8;                  // warps a CTA
constexpr int NTHR = NW * 32;
constexpr int ROW_TILE = 64;           // int4 rows an item (the q8 p tile)
constexpr int TAIL_TILE = 16;          // bf16 tail rows an item
constexpr int KG_MAX = 4;              // key groups a CTA (MTC >= 2)
constexpr int RG_HEADS = 16 * 8 + 1;   // kv heads a row group spans, at most
constexpr int MAX_SPLITS = 256;        // splits a row group (the merge's registers)
constexpr float LOG2E = 1.4426950408889634f;
// A stage (bytes). An int4 item: K rows (64 bytes each, contiguous: a
// lane's 16-byte reads of 8 rows cover 32 banks a quarter warp), V rows
// padded to 80 bytes (a half warp's 8-byte reads of four rows two apart hit
// distinct banks), the rows' k scale, k zero, v scale, v zero and row_head.
// A tail item: 16 K and 16 V bf16 rows padded to 272 bytes.
constexpr int KSTR = DP, VSTR = 80, TSTR = 2 * D + 16;
constexpr int OFF_V = ROW_TILE * KSTR;
constexpr int OFF_SC = OFF_V + ROW_TILE * VSTR;
constexpr int OFF_RH = OFF_SC + 4 * ROW_TILE * 4;
constexpr int STAGE = OFF_RH + ROW_TILE * 4;
constexpr int OFF_TV = TAIL_TILE * TSTR;
static_assert(2 * TAIL_TILE * TSTR <= STAGE, "a tail item must fit a stage");
// A bf16 segment item: 32 K and 32 V rows padded to 272 bytes, their row_head.
constexpr int BF_TILE = 32;
constexpr int OFF_BV = BF_TILE * TSTR;
constexpr int OFF_BRH = 2 * BF_TILE * TSTR;
constexpr int BSTAGE = OFF_BRH + BF_TILE * 4;
enum Mode { EXACT = 0, Q8 = 1, BF16 = 2 };
constexpr int VBSTR = D + 8;           // bf16 row of a dequantized V tile (ldmatrix on 32 banks)
constexpr int RSTR = D + 8;            // row stride of the key groups' merge (floats)
// A key group's shared memory: NST stages and, in the exact mode, the V
// tile of the stage being computed, dequantized once for the group's warps.
template <int MODE>
struct Ring {
  static constexpr int NST = MODE == Q8 ? 4 : 3;
  static constexpr int SEG = MODE == BF16 ? BF_TILE : ROW_TILE;  // rows a segment item
  static constexpr int STG = MODE == BF16 ? BSTAGE : STAGE;
  static constexpr int VB = MODE == EXACT ? ROW_TILE * VBSTR * 2 : 0;
  static constexpr int GROUP = NST * STG + VB;
  static constexpr int SMEM = KG_MAX * GROUP;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(KG_MAX * 16 * 2 * (RSTR + 3) * 4 <= SMEM, "the groups' merge");
  static_assert(2 * TAIL_TILE * TSTR <= STG, "a tail item must fit a stage");
};

struct Args {
  const bf16* q;                       // (T, H_all, D)
  const bf16* kb;                      // BF16 mode: the rows (D bf16)
  const bf16* vb;
  const uint8_t* kq;                   // packed rows (D/2 bytes), their scale and zero
  const float* ks;
  const float* kz;
  const uint8_t* vq;
  const float* vs;
  const float* vz;
  const int* row_head;
  const int* layer_off;                // pool: (L,) row offset and live rows; flat: null
  const int* layer_rows;
  const int* seg_rows;                 // flat: (L, n_seq) live rows a segment, or null (R_seg)
  const bf16* k_tail;                  // pool (L, Hkv, Tcap, D); flat (n_seq Hkv, Tcap, D)
  const bf16* v_tail;
  const int* tail_lens;                // pool (Hkv,), flat (n_seq Hkv,), or null
  bf16* out;                           // (T, H_all, D)
  float* part_acc;                     // (n_seq, RGS, S, 16 MTC, D), accumulator's column order
  float* part_ml;                      // (n_seq, RGS, S, 16 MTC, 2)
  unsigned* tickets;                   // (n_seq RGS,) zero between launches
  int T, H_all, Hkv, G, n_seq, Tcap, layer, R_seg, tail_len, S, mtc, rgs;
  float scale;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  unsigned s = sm90::smem_u32(smem);
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// bf16x2 of the nibbles n0 (low half) and n1 held in bits 0-3 and 16-19 of
// x: 0x4300 | n is the bf16 128 + n, exactly; minus 128 leaves n.
__device__ __forceinline__ uint32_t nib2(uint32_t x) {
  const uint32_t y = (x & 0x000f000fu) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The float value of byte k of w (a nibble), through the float 2^23 + n.
__device__ __forceinline__ float nib_f(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + k)) - 8388608.f;
}

// A 4x4 byte transpose: byte j of out[c] is byte c of in[j].
__device__ __forceinline__ void transpose4(const uint32_t in[4], uint32_t out[4]) {
  uint32_t t0 = __byte_perm(in[0], in[1], 0x5140), t1 = __byte_perm(in[0], in[1], 0x7362);
  uint32_t t2 = __byte_perm(in[2], in[3], 0x5140), t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// The bf16 A fragments of the warp's two q rows over D, in the permuted
// order of the key reads: step kk covers columns (kk / 4) * 64 + tig * 16 +
// (kk % 4) * 4 + {0, 1} (regs 0, 1) and + {2, 3} (regs 2, 3).
__device__ __forceinline__ void load_qa(uint32_t qa[KK_D][4], const bf16* lo, const bf16* hi,
                                        int tig) {
#pragma unroll
  for (int kk = 0; kk < KK_D; ++kk) {
    const int c = (kk >> 2) * DP + tig * 16 + (kk & 3) * 4;
    qa[kk][0] = lo ? ld32(lo + c) : 0u;
    qa[kk][1] = hi ? ld32(hi + c) : 0u;
    qa[kk][2] = lo ? ld32(lo + c + 2) : 0u;
    qa[kk][3] = hi ? ld32(hi + c + 2) : 0u;
  }
}

// A warp's running softmax for its two rows (lo, hi) and its output
// columns: acc[nt][j] is row gid + 8 (j >> 1), column
// (nt / 8) * 64 + (tig * 2 + (j & 1)) * 8 + nt % 8.
struct Run {
  float m[2], l[2];
  float acc[NT_D][4];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  // Scores s (natural units, -inf masked) -> probabilities; m and l
  // advance, alpha is the factor for acc. l stays a lane's partial sum.
  template <int NT>
  __device__ __forceinline__ void probs(float s[NT][4], float alpha[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      mu[i] = mn == -INFINITY ? 0.f : mn;
      alpha[i] = sm90::ex2((m[i] - mu[i]) * LOG2E);
      m[i] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sm90::ex2((s[nt][j] - mu[j >> 1]) * LOG2E);
        s[nt][j] = p;
        rs[j >> 1] += p;
      }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
  }

  __device__ __forceinline__ void rescale(const float alpha[2]) {
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
  }
};

// One warp's rows: their kv head within the sequence (-1 for a row past
// the sequence's rows), their query index, and q's row pointers.
struct Rows {
  int head[2], t[2];
  const bf16* ptr[2];
  int h_lo, h_hi;  // the warp's kv heads (h_lo > h_hi: none)
};

// Exact mode: the group's threads dequantize a stage's V rows once into
// vb (bf16 n * scale + zero, rounded once), the columns permuted as the
// p.v fragments want them: byte b's high nibble (column b) at b % 8 * 8 +
// b / 8, its low nibble (column 64 + b) 64 further, so that 8-column block
// nt of vb is the accumulator's tile nt. A thread takes one row's 64 bytes
// and some of its 8-column blocks: one 16-byte store a block.
__device__ __forceinline__ void expand_v(bf16* vb, const uint8_t* stg, int gt, int nthr) {
  const float* vsc = reinterpret_cast<const float*>(stg + OFF_SC) + 2 * ROW_TILE;
  const float* vzc = vsc + ROW_TILE;
  const int r = gt % ROW_TILE, per_row = nthr / ROW_TILE;
  const uint4* src = reinterpret_cast<const uint4*>(stg + OFF_V + r * VSTR);
  uint32_t wd[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 16; ++i) {
    const uint4 v = src[i];
    wd[4 * i] = v.x;
    wd[4 * i + 1] = v.y;
    wd[4 * i + 2] = v.z;
    wd[4 * i + 3] = v.w;
  }
  const float sc = vsc[r], z = vzc[r];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {  // bytes nb + 8n: word 2n + nb / 4, byte nb % 4
    if (nb % per_row != gt / ROW_TILE) continue;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      const uint32_t w0 = wd[2 * n + (nb >> 2)], w1 = wd[2 * n + 2 + (nb >> 2)];
      hi[n / 2] = pack_f32(fmaf(nib_f((w0 >> 4) & 0x0f0f0f0fu, nb & 3), sc, z),
                           fmaf(nib_f((w1 >> 4) & 0x0f0f0f0fu, nb & 3), sc, z));
      lo[n / 2] = pack_f32(fmaf(nib_f(w0 & 0x0f0f0f0fu, nb & 3), sc, z),
                           fmaf(nib_f(w1 & 0x0f0f0f0fu, nb & 3), sc, z));
    }
    *reinterpret_cast<uint4*>(vb + r * VBSTR + nb * 8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(vb + r * VBSTR + DP + nb * 8) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Exact mode, an int4 item: q.n from the K nibbles, folded with the rows'
// scale and zero; p.v against the group's dequantized V tile vb.
__device__ __forceinline__ void exact_tile(Run& st, const uint32_t qa[KK_D][4], const float qs[2],
                                           const uint8_t* stg, const bf16* vb, int nv, int match,
                                           const Rows& w, int lane, float scale) {
  const int gid = lane >> 2, tig = lane & 3;
  const float* sc = reinterpret_cast<const float*>(stg + OFF_SC);
  const int* rh = reinterpret_cast<const int*>(stg + OFF_RH);
  float s[NT_K][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // four 8-key tiles at a time, 4 mma chains
    uint4 kw[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      kw[n] = *reinterpret_cast<const uint4*>(stg + ((half * 4 + n) * 8 + gid) * KSTR + tig * 16);
    float c[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t p01[4], p23[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t x = kk == 0 ? kw[n].x : kk == 1 ? kw[n].y : kk == 2 ? kw[n].z : kw[n].w;
        p01[n] = __byte_perm(x, 0u, 0x4140);
        p23[n] = __byte_perm(x, 0u, 0x4342);
        mma16816(c[n], qa[kk], nib2(p01[n] >> 4), nib2(p23[n] >> 4));
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) mma16816(c[n], qa[kk + 4], nib2(p01[n]), nib2(p23[n]));
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = half * 4 + n, col = nt * 8 + tig * 2 + (j & 1);
        const bool ok = col < nv && rh[col] == match + w.head[j >> 1] && w.head[j >> 1] >= 0;
        s[nt][j] =
            ok ? (c[n][j] * sc[col] + qs[j >> 1] * sc[ROW_TILE + col]) * scale : -INFINITY;
      }
  }
  float alpha[2];
  st.probs<NT_K>(s, alpha);
  st.rescale(alpha);
#pragma unroll
  for (int kk = 0; kk < ROW_TILE / 16; ++kk) {
    const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                           pack_f32(s[2 * kk][2], s[2 * kk][3]),
                           pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NT_D / 2; ++np) {  // two 8-column tiles a transposed load
      uint32_t b[4];
      sm90::ldsm_x4_t(b, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VBSTR + np * 16 +
                             (lane >> 4) * 8);
      mma16816(st.acc[2 * np], a, b[0], b[1]);
      mma16816(st.acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// q8 mode, an int4 item: s8 products on the raw bytes (see the top).
__device__ __forceinline__ void q8_tile(Run& st, const Q8Rows& q8, const uint8_t* stg, int nv,
                                        int match, const Rows& w, int gid, int tig,
                                        float scale) {
  const float* sc = reinterpret_cast<const float*>(stg + OFF_SC);
  const int* rh = reinterpret_cast<const int*>(stg + OFF_RH);
  float s[NT_K][4];
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt) {
    const uint4 kw = *reinterpret_cast<const uint4*>(stg + (nt * 8 + gid) * KSTR + tig * 16);
    const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
    int a4[4] = {0, 0, 0, 0}, l4[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t w0 = words[2 * kk], w1 = words[2 * kk + 1];
      mma_s8(a4, q8.qh[kk], w0 ^ 0x80808080u, w1 ^ 0x80808080u);
      mma_s8(l4, q8.ql[kk], w0 & 0x0f0f0f0fu, w1 & 0x0f0f0f0fu);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j >> 1, col = nt * 8 + tig * 2 + (j & 1);
      const float qn = q8.qh_s[i] * (static_cast<float>(a4[j]) + 128.f * q8.bsum[i]) +
                       q8.ql_s[i] * static_cast<float>(l4[j]);
      const bool ok = col < nv && rh[col] == match + w.head[i] && w.head[i] >= 0;
      s[nt][j] = ok ? (qn * sc[col] + q8.qsum[i] * sc[ROW_TILE + col]) * scale : -INFINITY;
    }
  }
  float alpha[2];
  st.probs<NT_K>(s, alpha);
  // ps = p * v_scale, quantized per row over the tile
  const float* vsc = sc + 2 * ROW_TILE;
  const float* vzc = sc + 3 * ROW_TILE;
  float pmax[2] = {0.f, 0.f}, pz[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = nt * 8 + tig * 2 + (j & 1);
      const float p = s[nt][j];
      pz[j >> 1] += p * vzc[col];
      s[nt][j] = p * vsc[col];
      pmax[j >> 1] = fmaxf(pmax[j >> 1], s[nt][j]);
    }
  float ps_s[2], rcp[2], psum[2];
  int pi[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ps_s[i] = quad_max(pmax[i]) / 127.f + 1e-20f;
    rcp[i] = 1.f / ps_s[i];
    pz[i] = quad_sum(pz[i]);
  }
  uint32_t v8[NT_K][2];  // [nt][row]: the quantized p of columns tig*2, tig*2+1 as two bytes
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int a = static_cast<int>(rintf(div_rn(s[nt][2 * i], ps_s[i], rcp[i])));
      const int b = static_cast<int>(rintf(div_rn(s[nt][2 * i + 1], ps_s[i], rcp[i])));
      pi[i] += a + b;
      v8[nt][i] = (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) psum[i] = static_cast<float>(quad_sum_int(pi[i]));
  // A fragments of step kk (32 keys): bytes j of reg 0 are keys
  // 32kk + (j >> 1) * 8 + tig * 2 + (j & 1) of row lo; reg 2 the same + 16
  uint32_t pa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pa[kk][i] = v8[4 * kk][i] | (v8[4 * kk + 1][i] << 16);
      pa[kk][2 + i] = v8[4 * kk + 2][i] | (v8[4 * kk + 3][i] << 16);
    }
  int m1[NT_K][4], m2[NT_K][4];
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) m1[nt][j] = m2[nt][j] = 0;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint2 vw[2][4];  // [half][i]: keys 32kk + half*16 + tig*2 + {0, 1, 8, 9}
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kk * 32 + h * 16 + tig * 2 + (i & 1) + (i >> 1) * 8;
        vw[h][i] = *reinterpret_cast<const uint2*>(stg + OFF_V + r * VSTR + gid * 8);
      }
#pragma unroll
    for (int wsel = 0; wsel < 2; ++wsel) {  // bytes gid * 8 + wsel * 4 + c
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t in[4] = {wsel ? vw[h][0].y : vw[h][0].x, wsel ? vw[h][1].y : vw[h][1].x,
                                wsel ? vw[h][2].y : vw[h][2].x, wsel ? vw[h][3].y : vw[h][3].x};
        transpose4(in, b[h]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int nt = wsel * 4 + c;
        mma_s8(m1[nt], pa[kk], b[0][c] ^ 0x80808080u, b[1][c] ^ 0x80808080u);
        mma_s8(m2[nt], pa[kk], b[0][c] & 0x0f0f0f0fu, b[1][c] & 0x0f0f0f0fu);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j >> 1;
      const float f1 = ps_s[i] * (static_cast<float>(m1[nt][j]) + 128.f * psum[i]);
      const float f2 = ps_s[i] * static_cast<float>(m2[nt][j]);
      st.acc[nt][j] = st.acc[nt][j] * alpha[i] + pz[i] + (f1 - f2) * 0.0625f;
      st.acc[nt + 8][j] = st.acc[nt + 8][j] * alpha[i] + pz[i] + f2;
    }
}

// NK bf16 key rows (a tail item, or a segment item in BF16 mode): K rows at
// kst, V rows at vst, TSTR bytes apart; ok(col, i) says whether key col is
// visible to the warp's row i (0: gid, 1: gid + 8).
template <int NK, class Ok>
__device__ __forceinline__ void bf16_tile(Run& st, const uint32_t qa[KK_D][4], const uint8_t* kst,
                                          const uint8_t* vst, const Ok& ok, int gid, int tig,
                                          float scale) {
  float s[NK / 8][4];
#pragma unroll
  for (int nt = 0; nt < NK / 8; ++nt) {
    const uint8_t* kr = kst + (nt * 8 + gid) * TSTR + tig * 32;
    const uint4 h0 = *reinterpret_cast<const uint4*>(kr);
    const uint4 h1 = *reinterpret_cast<const uint4*>(kr + 16);
    const uint4 l0 = *reinterpret_cast<const uint4*>(kr + 2 * DP);
    const uint4 l1 = *reinterpret_cast<const uint4*>(kr + 2 * DP + 16);
    const uint32_t b[KK_D][2] = {{h0.x, h0.y}, {h0.z, h0.w}, {h1.x, h1.y}, {h1.z, h1.w},
                                 {l0.x, l0.y}, {l0.z, l0.w}, {l1.x, l1.y}, {l1.z, l1.w}};
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KK_D; ++kk) mma16816(c, qa[kk], b[kk][0], b[kk][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] = ok(nt * 8 + tig * 2 + (j & 1), j >> 1) ? c[j] * scale
                                                                             : -INFINITY;
  }
  float alpha[2];
  st.probs<NK / 8>(s, alpha);
  st.rescale(alpha);
#pragma unroll
  for (int kc = 0; kc < NK / 16; ++kc) {  // 16 keys a p.v step
    const uint32_t a[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                           pack_f32(s[2 * kc][2], s[2 * kc][3]),
                           pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                           pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
    const int r0 = kc * 16 + tig * 2;
    const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // columns half * 64 + gid * 8 + k
      uint4 vw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        vw[i] = *reinterpret_cast<const uint4*>(vst + rows[i] * TSTR + half * 2 * DP + gid * 16);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t wds[4] = {vw[i].x, vw[i].y, vw[i].z, vw[i].w};
          x[i] = wds[k >> 1];
        }
        const uint32_t sel = (k & 1) ? 0x7632 : 0x5410;
        mma16816(st.acc[half * 8 + k], a, __byte_perm(x[0], x[1], sel),
                 __byte_perm(x[2], x[3], sel));
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTHR, 1) int4_decode_kernel(const Args a) {
  constexpr bool Q8M = MODE == Q8;
  constexpr int SEG = Ring<MODE>::SEG, STG = Ring<MODE>::STG;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int s_tl[RG_HEADS], s_len[RG_HEADS];

  const int rg = blockIdx.x, split = blockIdx.y, sb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int MTC = a.mtc, KG = NW / MTC, RG = 16 * MTC, S = a.S, GTH = MTC * 32;
  const int kg = warp / MTC, mt = warp % MTC, gt = tid - kg * GTH;
  const int GT = a.G * a.T;  // query rows a kv head
  const int H = a.Hkv * a.G;  // query heads a sequence
  const int r0 = rg * RG, nrows = min(RG, a.Hkv * GT - r0);
  const int grp = sb * a.rgs + rg;

  // The segment (pool: the layer's rows; flat: the sequence's) and the
  // tails of the row group's kv heads h_lo ... h_lo + n_heads - 1.
  const bool pool = a.layer_off != nullptr;
  const size_t base = pool ? static_cast<size_t>(a.layer_off[a.layer])
                           : (static_cast<size_t>(a.layer) * a.n_seq + sb) * a.R_seg;
  const int n_rows = pool ? a.layer_rows[a.layer]
                   : a.seg_rows ? max(0, min(a.seg_rows[a.layer * a.n_seq + sb], a.R_seg))
                                : a.R_seg;
  const int match = pool ? 0 : sb * a.Hkv;  // row_head of the sequence's kv head 0
  const size_t tail0 = pool ? static_cast<size_t>(a.layer) * a.Hkv : match;
  const int h_lo = r0 / GT, n_heads = (r0 + nrows - 1) / GT - h_lo + 1;
  for (int h = tid; h < n_heads; h += NTHR) {
    const int tl = a.tail_lens ? a.tail_lens[match + h_lo + h] : a.tail_len;
    s_tl[h] = tl;
    s_len[h] = max(0, min(tl + a.T, a.Tcap));
  }

  // this warp's rows, and their q words in flight across the barrier
  Rows w;
  w.h_lo = 1;
  w.h_hi = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = mt * 16 + gid + 8 * i, gr = r0 + rl;
    w.head[i] = -1;
    w.t[i] = 0;
    w.ptr[i] = nullptr;
    if (rl < nrows) {
      const int hk = gr / GT, rem = gr % GT, g = rem / a.T;
      w.head[i] = hk;
      w.t[i] = rem % a.T;
      w.ptr[i] = a.q + (static_cast<size_t>(w.t[i]) * a.H_all + sb * H + hk * a.G + g) * D;
    }
  }
  if (mt * 16 < nrows) {
    w.h_lo = (r0 + mt * 16) / GT;
    w.h_hi = (r0 + min(mt * 16 + 15, nrows - 1)) / GT;
  }
  uint32_t qa[KK_D][4];
  uint4 qraw[2][4];
  if constexpr (Q8M) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        qraw[i][v] = w.ptr[i] ? *reinterpret_cast<const uint4*>(w.ptr[i] + (v >> 1) * DP +
                                                               tig * 16 + (v & 1) * 8)
                              : make_uint4(0u, 0u, 0u, 0u);
  } else {
    load_qa(qa, w.ptr[0], w.ptr[1], tig);
  }
  __syncthreads();
  int n_tail = 0;
  for (int h = 0; h < n_heads; ++h) n_tail += (s_len[h] + TAIL_TILE - 1) / TAIL_TILE;
  const int n_seg = (n_rows + SEG - 1) / SEG;
  const int n_items = n_seg + n_tail;

  // item it: (tail?, first row, rows loaded, tail head index)
  auto item = [&](int it, int& c0, int& nv, int& h) {
    if (it < n_seg) {
      c0 = it * SEG;
      nv = min(SEG, n_rows - c0);
      h = -1;
      return false;
    }
    int j = it - n_seg;
    h = 0;
    for (int n = (s_len[0] + TAIL_TILE - 1) / TAIL_TILE; j >= n;
         n = (s_len[++h] + TAIL_TILE - 1) / TAIL_TILE)
      j -= n;
    c0 = j * TAIL_TILE;
    nv = min(TAIL_TILE, s_len[h] - c0);
    return true;
  };

  // the key group's threads copy item `it` into a stage; rows past nv zero
  auto load = [&](uint8_t* stg, int it) {
    int c0, nv, h;
    const bool seg = !item(it, c0, nv, h);
    if (seg && MODE == BF16) {
      const bf16* kg_ = a.kb + (base + c0) * D;
      const bf16* vg_ = a.vb + (base + c0) * D;
      for (int j = gt; j < BF_TILE * (D / 8); j += GTH) {
        const int r = j >> 4, c = (j & 15) * 8;
        const bool ok = r < nv;
        const size_t o = ok ? static_cast<size_t>(r) * D + c : 0;
        cp_async16(stg + r * TSTR + c * 2, kg_ + o, ok);
        cp_async16(stg + OFF_BV + r * TSTR + c * 2, vg_ + o, ok);
      }
      for (int r = gt; r < BF_TILE; r += GTH)
        cp_async4(stg + OFF_BRH + r * 4, a.row_head + base + c0 + (r < nv ? r : 0), r < nv);
    } else if (seg) {
      const uint8_t* kg_ = a.kq + (base + c0) * DP;
      const uint8_t* vg_ = a.vq + (base + c0) * DP;
      for (int j = gt; j < ROW_TILE * (DP / 16); j += GTH) {
        const int r = j >> 2, c = (j & 3) * 16;
        const bool ok = r < nv;
        const size_t o = ok ? static_cast<size_t>(r) * DP + c : 0;
        cp_async16(stg + r * KSTR + c, kg_ + o, ok);
        cp_async16(stg + OFF_V + r * VSTR + c, vg_ + o, ok);
      }
      for (int j = gt; j < 5 * ROW_TILE; j += GTH) {
        const int v = j / ROW_TILE, r = j % ROW_TILE;
        const bool ok = r < nv;
        const float* src = v == 0 ? a.ks : v == 1 ? a.kz : v == 2 ? a.vs : v == 3 ? a.vz
                         : reinterpret_cast<const float*>(a.row_head);
        cp_async4(stg + OFF_SC + j * 4, src + base + c0 + (ok ? r : 0), ok);
      }
    } else {
      const size_t off = ((tail0 + h_lo + h) * a.Tcap + c0) * D;
      const bf16* kt = a.k_tail + off;
      const bf16* vt = a.v_tail + off;
      for (int j = gt; j < TAIL_TILE * (D / 8); j += GTH) {
        const int r = j >> 4, c = (j & 15) * 8;
        const bool ok = r < nv;
        const size_t o = ok ? static_cast<size_t>(r) * D + c : 0;
        cp_async16(stg + r * TSTR + c * 2, kt + o, ok);
        cp_async16(stg + OFF_TV + r * TSTR + c * 2, vt + o, ok);
      }
    }
  };

  float qs[2] = {0.f, 0.f};
  Q8Rows q8;
  // The CTA's items are split, split + S, ... (interleaved, so every CTA
  // holds its share of each kv head's tiles); key group kg takes every
  // KG-th of them, the first NST - 1 issued before q's fragments are made.
  const int n_cta = split < n_items ? (n_items - split + S - 1) / S : 0;
  const int n_my = n_cta > kg ? (n_cta - kg + KG - 1) / KG : 0;
  auto item_of = [&](int k) { return split + S * (kg + KG * k); };
  constexpr int NST = Ring<MODE>::NST;
  uint8_t* ring = smem_raw + kg * Ring<MODE>::GROUP;
  bf16* vb = reinterpret_cast<bf16*>(ring + NST * STG);
#pragma unroll
  for (int k = 0; k < NST - 1; ++k) {
    if (k < n_my) load(ring + k * STG, item_of(k));
    sm90::cp_async_commit();
  }
  if constexpr (Q8M)
    q8.make(qraw);
  else if constexpr (MODE == EXACT)
    q_row_sums(qa, qs);
  Run st;
  st.init();
  for (int k = 0; k < n_my; ++k) {
    sm90::cp_async_wait<NST - 2>();
    sm90::named_bar(1 + kg, GTH);  // stage k landed for the group; stage k - 1 is free
    if (k + NST - 1 < n_my) load(ring + ((k + NST - 1) % NST) * STG, item_of(k + NST - 1));
    sm90::cp_async_commit();
    const uint8_t* stg = ring + (k % NST) * STG;
    int c0, nv, h;
    const bool tail = item(item_of(k), c0, nv, h);
    if constexpr (MODE == EXACT) {
      if (!tail) {
        expand_v(vb, stg, gt, GTH);
        sm90::named_bar(1 + kg, GTH);  // vb holds stage k's values
      }
    }
    if (w.h_lo > w.h_hi) continue;
    if (!tail) {
      const int* rh = reinterpret_cast<const int*>(stg + (MODE == BF16 ? OFF_BRH : OFF_RH));
      const int lo = match + w.h_lo, hi = match + w.h_hi;
      bool mine = false;
#pragma unroll
      for (int r = lane; r < SEG; r += 32) mine |= r < nv && rh[r] >= lo && rh[r] <= hi;
      if (!__any_sync(0xffffffffu, mine)) continue;  // no row of this warp's heads
      if constexpr (Q8M) {
        q8_tile(st, q8, stg, nv, match, w, gid, tig, a.scale);
      } else if constexpr (MODE == EXACT) {
        exact_tile(st, qa, qs, stg, vb, nv, match, w, lane, a.scale);
      } else {
        const auto ok = [&](int col, int i) {
          return col < nv && rh[col] == match + w.head[i] && w.head[i] >= 0;
        };
        bf16_tile<BF_TILE>(st, qa, stg, stg + OFF_BV, ok, gid, tig, a.scale);
      }
    } else {
      if (h_lo + h < w.h_lo || h_lo + h > w.h_hi) continue;
      const int hd = h_lo + h, tl = s_tl[h];
      const auto ok = [&](int col, int i) {
        return col < nv && w.head[i] == hd && c0 + col < tl + w.t[i] + 1;
      };
      if constexpr (Q8M) {
        uint32_t qt[KK_D][4];
        load_qa(qt, w.ptr[0], w.ptr[1], tig);
        bf16_tile<TAIL_TILE>(st, qt, stg, stg + OFF_TV, ok, gid, tig, a.scale);
      } else {
        bf16_tile<TAIL_TILE>(st, qa, stg, stg + OFF_TV, ok, gid, tig, a.scale);
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every group is done with its ring: reuse it

  // merge the key groups: red[kg][row][RSTR], rml[kg][row] = (m, l), then
  // each row's weight a group (wgt[kg][row]) and the CTA's (M, L)
  float* red = reinterpret_cast<float*>(smem_raw);
  float* rml = red + KG * RG * RSTR;
  float* wgt = rml + KG * RG * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = mt * 16 + gid + 8 * i;
    const float lsum = quad_sum(st.l[i]);
    if (tig == 0) {
      rml[(kg * RG + rl) * 2] = st.m[i];
      rml[(kg * RG + rl) * 2 + 1] = lsum;
    }
    // a lane's pair (acc[nt][2i], acc[nt][2i + 1]) at nt * 8 + tig * 2: one
    // float2 store a tile, the 8 rows 8 banks apart (RSTR = 136)
    float* dst = red + (kg * RG + rl) * RSTR + tig * 2;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt)
      *reinterpret_cast<float2*>(dst + nt * 8) =
          make_float2(st.acc[nt][2 * i], st.acc[nt][2 * i + 1]);
  }
  __syncthreads();
  float* pacc = a.part_acc + (static_cast<size_t>(grp) * S + split) * RG * D;
  float* pml = a.part_ml + (static_cast<size_t>(grp) * S + split) * RG * 2;
  if (tid < nrows) {
    float M = -INFINITY, L = 0.f;
    for (int g = 0; g < KG; ++g) M = fmaxf(M, rml[(g * RG + tid) * 2]);
    for (int g = 0; g < KG; ++g) {
      const float f = M == -INFINITY ? 0.f : sm90::ex2((rml[(g * RG + tid) * 2] - M) * LOG2E);
      wgt[g * RG + tid] = f;
      L += f * rml[(g * RG + tid) * 2 + 1];
    }
    *reinterpret_cast<float2*>(pml + tid * 2) = make_float2(M, L);
  }
  __syncthreads();
  for (int u = tid; u < nrows * (D / 4); u += NTHR) {  // the partial in red's column order
    const int r = u / (D / 4), p = (u % (D / 4)) * 4;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < KG; ++g) {
      const float f = wgt[g * RG + r];
      const float4 x = *reinterpret_cast<const float4*>(red + (g * RG + r) * RSTR + p);
      A.x += f * x.x;
      A.y += f * x.y;
      A.z += f * x.z;
      A.w += f * x.w;
    }
    *reinterpret_cast<float4*>(pacc + r * D + p) = A;
  }

  // Publish: count the partial with a release reduction (the barrier before
  // it orders the whole CTA's partial before thread 0's release), wait until
  // the row group's S partials are counted (acquire), then add once more;
  // the CTA that brings the count to 2 S zeroes it for the next launch
  // (every CTA of the group has seen S by then).
  unsigned* count = a.tickets + grp;
  __syncthreads();
  if (tid == 0) {
    sm90::red_add_release(count, 1u);
    uint32_t polls = 0;
    while (static_cast<int>(sm90::ld_relaxed(count)) < S)
      if (++polls == (1u << 24)) __trap();  // a CTA that never arrives
    sm90::fence_acq_rel();
    if (sm90::atom_add(count, 1u) == 2u * S - 1) *count = 0u;
  }
  __syncthreads();

  // This CTA's slice of the row group's output: units u0 ... u1 - 1 of
  // nrows x D / 4 float4 columns. One warp a row makes the split weights;
  // then the threads split the units and the splits and sum.
  constexpr int C4 = D / 4;
  const int units = nrows * C4, U = (units + S - 1) / S;
  const int u0 = split * U, u1 = min(units, u0 + U);
  if (u0 >= u1) return;
  const int ra = u0 / C4, nr = (u1 - 1) / C4 - ra + 1;
  float* wts = reinterpret_cast<float*>(smem_raw);  // [nr][S]
  float* inv = wts + nr * S;                        // [nr]
  float4* red4 = reinterpret_cast<float4*>(smem_raw + 8192);
  for (int rr = warp; rr < nr; rr += NW) {  // lanes over the splits, all loads at once
    const float2* ml = reinterpret_cast<const float2*>(a.part_ml) +
                       static_cast<size_t>(grp) * S * RG + ra + rr;
    float2 v[MAX_SPLITS / 32];
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      const int s_ = lane + 32 * i;
      v[i] = s_ < S ? __ldcg(ml + static_cast<size_t>(s_) * RG) : make_float2(-INFINITY, 0.f);
      M = fmaxf(M, v[i].x);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SPLITS / 32; ++i) {
      const int s_ = lane + 32 * i;
      const float f = M == -INFINITY ? 0.f : sm90::ex2((v[i].x - M) * LOG2E);
      if (s_ < S) wts[rr * S + s_] = f;
      L += f * v[i].y;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) inv[rr] = 1.f / fmaxf(L, 1e-37f);
  }
  __syncthreads();
  const float4* p4 =
      reinterpret_cast<const float4*>(a.part_acc) + static_cast<size_t>(grp) * S * RG * C4;
  auto sum = [&](int u, int j0, int J) {
    const int r = u / C4;
    const float* wr = wts + (r - ra) * S;
    const float4* src = p4 + static_cast<size_t>(r) * C4 + u % C4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = j0; s < S; s += J) {
      const float f = wr[s];
      const float4 v = __ldcg(src + static_cast<size_t>(s) * RG * C4);
      acc.x += f * v.x;
      acc.y += f * v.y;
      acc.z += f * v.z;
      acc.w += f * v.w;
    }
    return acc;
  };
  // unit u holds partial columns p ... p + 3 of its row: tile nt = p / 8,
  // output columns (nt / 8) * 64 + (p % 8 + j) * 8 + nt % 8
  auto write = [&](int u, float4 v) {
    const int r = u / C4, gr = r0 + r, hk = gr / GT, rem = gr % GT, p = (u % C4) * 4;
    const float f = inv[r - ra];
    bf16* o = a.out + (static_cast<size_t>(rem % a.T) * a.H_all + sb * H + hk * a.G + rem / a.T) *
                          D + ((p >> 6) << 6) + (p & 7) * 8 + ((p >> 3) & 7);
    o[0] = __float2bfloat16_rn(v.x * f);
    o[8] = __float2bfloat16_rn(v.y * f);
    o[16] = __float2bfloat16_rn(v.z * f);
    o[24] = __float2bfloat16_rn(v.w * f);
  };
  const int nu = u1 - u0;
  if (nu >= NTHR) {
    for (int u = u0 + tid; u < u1; u += NTHR) write(u, sum(u, 0, 1));
    return;
  }
  const int J = NTHR / nu, j = tid / nu;
  if (j < J) red4[j * nu + tid % nu] = sum(u0 + tid % nu, j, J);
  __syncthreads();
  if (tid < nu) {
    float4 t = red4[tid];
    for (int jj = 1; jj < J; ++jj) {
      const float4 v = red4[jj * nu + tid];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    write(u0 + tid, t);
  }
}

// Launch on `stream`: grid (rgs, S, n_seq) of NTHR threads, Ring<MODE>::SMEM
// bytes of dynamic shared memory each. The wrapper plans it (ops/int4_decode.py):
// with S > 1 the grid must fit the card at once. Static: K3, K7, K10 and K11
// are four libraries in one process, and an inline function's local static
// would be one object for all (so a later library would skip setting its
// own kernel's shared-memory limit); a template instantiates only the
// modes its library launches.
template <int MODE>
static int launch(const Args& a, cudaStream_t stream) {
  static bool attr[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr[dev]) {
    cudaError_t e = cudaFuncSetAttribute(int4_decode_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<MODE>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr[dev] = true;
  }
  const int rows = a.Hkv * a.G * a.T;
  if ((a.mtc != 2 && a.mtc != 4 && a.mtc != 8) || a.S < 1 || a.S > MAX_SPLITS || a.Hkv < 1 ||
      a.rgs != (rows + 16 * a.mtc - 1) / (16 * a.mtc))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a.rgs, a.S, a.n_seq);
  int4_decode_kernel<MODE><<<grid, NTHR, Ring<MODE>::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i4d
}  // namespace kvz
