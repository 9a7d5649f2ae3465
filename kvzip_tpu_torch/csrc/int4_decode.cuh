// Shared body of the int4 decode kernels K7 (pool) and K11 (flat): one
// CTA's flash-decoding partial over a range of int4 context rows, or over
// the bf16 tail, in the exact mode or the int8-attention (q8) mode.
//
// Exact mode: K7's tiles (int4_common.cuh): keys as nibbles with scale and
// zero folded out of q.k in float32, values dequantized to bf16.
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
// dots against the transposed byte tile; Σ p.v = ((ps.b - ps.lo) / 16,
// ps.lo) + Σ p.v_zero. The int32 sums are exact; p is quantized per 64-key
// tile aligned to the segment's row 0, which the plain version repeats.
#pragma once

#include "int4_common.cuh"

namespace kvz {

constexpr int QP = 80;  // padded byte row of the q8 tiles: fragment loads hit 32 banks

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int quad_sum_int(int x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The warp's two q rows (lo = gid, hi = gid + 8) quantized for the q8
// score product: s8 A fragments of m16n8k32 over the D/2 = 64 columns
// (qh of q_hi, ql of q_lo'), and per row the two scales, sum(qh8) and
// sum(q). A lane holds columns kk * 32 + half * 16 + tig * 4 + j.
struct Q8Rows {
  uint32_t qh[2][4], ql[2][4];
  float qh_s[2], ql_s[2], bsum[2], qsum[2];

  __device__ __forceinline__ void load(const bf16* lo, const bf16* hi, int tig) {
    const bf16* rows[2] = {lo, hi};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float xh[16], xl[16], amax_h = 0.f, amax_l = 0.f, sum = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        int c = (e >> 3) * 32 + ((e >> 2) & 1) * 16 + tig * 4 + (e & 3);
        float a = rows[i] ? __bfloat162float(rows[i][c]) : 0.f;
        float b = rows[i] ? __bfloat162float(rows[i][c + DP]) : 0.f;
        xh[e] = a * 0.0625f;
        xl[e] = b - xh[e];
        amax_h = fmaxf(amax_h, fabsf(xh[e]));
        amax_l = fmaxf(amax_l, fabsf(xl[e]));
        sum += a + b;
      }
      qh_s[i] = quad_max(amax_h) / 127.f + 1e-20f;
      ql_s[i] = quad_max(amax_l) / 127.f + 1e-20f;
      qsum[i] = quad_sum(sum);
      int bs = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // register r: kk = r >> 1, half = r & 1
        uint32_t wh = 0u, wl = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int e = r * 4 + j;
          int vh = static_cast<int>(rintf(xh[e] / qh_s[i]));
          int vl = static_cast<int>(rintf(xl[e] / ql_s[i]));
          bs += vh;
          wh |= (static_cast<uint32_t>(vh) & 0xffu) << (8 * j);
          wl |= (static_cast<uint32_t>(vl) & 0xffu) << (8 * j);
        }
        // A fragment: reg 0 = row lo, cols tig*4; 1 = row hi; 2, 3 = +16
        qh[r >> 1][(r & 1) * 2 + i] = wh;
        ql[r >> 1][(r & 1) * 2 + i] = wl;
      }
      bsum[i] = static_cast<float>(quad_sum_int(bs));
    }
  }
};

// One CTA's partial for the queries of kv head blockIdx.y (query heads
// blockIdx.y * G ... + G - 1 of q (T, H_all, D)) and packed rows
// blockIdx.z * 64 ... of R = G * T (row r: query r % T of head r / T), over
// context rows [k0, k1) of a segment (kq ... rh point at its row 0; a row
// is the CTA's iff rh == blockIdx.y) or, with is_tail, over the bf16 tail
// kt/vt, where tail row j is visible to query i iff j < tail_len + i + 1.
// Writes split `split` of S of the flash-decoding partials.
template <bool Q8>
__device__ __forceinline__ void int4_decode_partial(
    const bf16* __restrict__ q, int H_all, int G, int T, const uint8_t* __restrict__ kq,
    const float* __restrict__ ks, const float* __restrict__ kz, const uint8_t* __restrict__ vq,
    const float* __restrict__ vs, const float* __restrict__ vz, const int* __restrict__ rhg,
    int k0, int k1, bool is_tail, const bf16* __restrict__ kt, const bf16* __restrict__ vt,
    int tail_len, float* part_acc, float* part_ml, int split, int S, float scale) {
  __shared__ __align__(16) unsigned char sm[2 * BK * SROW * sizeof(bf16)];
  __shared__ float ksc[BK], kzc[BK], vsc[BK], vzc[BK];
  __shared__ int rh[BK];
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = Ks + BK * SROW;
  // q8 tiles (segment splits only): K bytes (key, byte), V bytes
  // transposed (byte, key), each warp's quantized p (row, key)
  uint8_t* Kb = sm;
  uint8_t* Vt = sm + BK * QP;
  const int hg = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  int8_t* P8 = reinterpret_cast<int8_t*>(sm + BK * QP + DP * QP) + warp * 16 * QP;
  const int R = G * T;
  const int r_lo = blockIdx.z * 64 + warp * 16 + gid, r_hi = r_lo + 8;
  const bool active = blockIdx.z * 64 + warp * 16 < R;
  const int qi_lo = r_lo % T, qi_hi = r_hi % T;
  const bf16* q_lo = r_lo < R ? q + (static_cast<size_t>(qi_lo) * H_all + hg * G + r_lo / T) * D : nullptr;
  const bf16* q_hi = r_hi < R ? q + (static_cast<size_t>(qi_hi) * H_all + hg * G + r_hi / T) * D : nullptr;

  uint32_t qa[KK_D][4];
  float qs[2];
  Q8Rows q8;
  if (is_tail || !Q8) {
    load_q(qa, q_lo, q_hi, tig);
    q_row_sums(qa, qs);
  } else {
    q8.load(q_lo, q_hi, tig);
  }

  Online st;
  st.init();
  bool any_tile = false;
  for (int c0 = k0; c0 < k1; c0 += BK) {
    int n = min(BK, k1 - c0);
    __syncthreads();
    if (!is_tail) {
      int mine = 0;
      if (tid < BK) {
        int id = tid < n ? rhg[c0 + tid] : -1;
        rh[tid] = id;
        mine = id == hg;
      }
      if (!__syncthreads_or(mine)) continue;  // no row of this kv head in the tile
      if (Q8) {
        for (int r = tid; r < BK; r += nthr) {
          bool ok = r < n;
          ksc[r] = ok ? ks[c0 + r] : 0.f;
          kzc[r] = ok ? kz[c0 + r] : 0.f;
          vsc[r] = ok ? vs[c0 + r] : 0.f;
          vzc[r] = ok ? vz[c0 + r] : 0.f;
        }
        for (int i = tid; i < BK * (DP / 16); i += nthr) {
          int r = i / (DP / 16), c = (i % (DP / 16)) * 16;
          bool ok = r < n;
          const uint8_t* src = kq + (static_cast<size_t>(c0) + (ok ? r : 0)) * DP + c;
          cp_async16(Kb + r * QP + c, src, ok);
          uint4 w = ok ? *reinterpret_cast<const uint4*>(vq + (static_cast<size_t>(c0) + r) * DP + c)
                       : make_uint4(0u, 0u, 0u, 0u);
          const uint8_t* b = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
          for (int j = 0; j < 16; ++j) Vt[(c + j) * QP + r] = b[j];
        }
        cp_async_wait_all();
      } else {
        load_tile_int4<false>(Ks, ksc, kzc, kq, DP, ks, kz, 1, c0, n, tid, nthr);
        load_tile_int4<true>(Vs, nullptr, nullptr, vq, DP, vs, vz, 1, c0, n, tid, nthr);
      }
    } else {
      load_tile(Ks, kt, c0, n, tid, nthr);
      load_tile(Vs, vt, c0, n, tid, nthr);
      cp_async_wait_all();
    }
    any_tile = true;
    __syncthreads();
    if (!active) continue;
    float s[NT_K][4];
    if (Q8 && !is_tail) {
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
        int a4[4] = {0, 0, 0, 0}, l4[4] = {0, 0, 0, 0};
        const uint8_t* kr = Kb + (nt * 8 + gid) * QP + tig * 4;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t w0 = ld_u32(kr + kk * 32), w1 = ld_u32(kr + kk * 32 + 16);
          mma_s8(a4, q8.qh[kk], w0 ^ 0x80808080u, w1 ^ 0x80808080u);
          mma_s8(l4, q8.ql[kk], w0 & 0x0f0f0f0fu, w1 & 0x0f0f0f0fu);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int i = j >> 1, cl = nt * 8 + tig * 2 + (j & 1);
          float qn = q8.qh_s[i] * (static_cast<float>(a4[j]) + 128.f * q8.bsum[i]) +
                     q8.ql_s[i] * static_cast<float>(l4[j]);
          s[nt][j] = rh[cl] == hg ? (qn * ksc[cl] + q8.qsum[i] * kzc[cl]) * scale : -INFINITY;
        }
      }
      float alpha[2];
      st.probs(s, alpha);
      // ps = p * v_scale, quantized per row over the tile
      float pmax[2] = {0.f, 0.f}, pz[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int cl = nt * 8 + tig * 2 + (j & 1);
          float p = s[nt][j];
          pz[j >> 1] += p * vzc[cl];
          s[nt][j] = p * vsc[cl];
          pmax[j >> 1] = fmaxf(pmax[j >> 1], s[nt][j]);
        }
      }
      float ps_s[2], psum[2];
      int pi[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps_s[i] = quad_max(pmax[i]) / 127.f + 1e-20f;
        pz[i] = quad_sum(pz[i]);
      }
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int i = j >> 1;
          int v = static_cast<int>(rintf(s[nt][j] / ps_s[i]));
          pi[i] += v;
          P8[(gid + 8 * i) * QP + nt * 8 + tig * 2 + (j & 1)] = static_cast<int8_t>(v);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) psum[i] = static_cast<float>(quad_sum_int(pi[i]));
      __syncwarp();
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint8_t* pr = reinterpret_cast<const uint8_t*>(P8) + gid * QP + kk * 32 + tig * 4;
        pa[kk][0] = ld_u32(pr);
        pa[kk][1] = ld_u32(pr + 8 * QP);
        pa[kk][2] = ld_u32(pr + 16);
        pa[kk][3] = ld_u32(pr + 8 * QP + 16);
      }
      __syncwarp();  // P8 is rewritten by the next tile
#pragma unroll
      for (int nt = 0; nt < NT_K; ++nt) {
        int m1[4] = {0, 0, 0, 0}, m2[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint8_t* vr = Vt + (nt * 8 + gid) * QP + kk * 32 + tig * 4;
          uint32_t w0 = ld_u32(vr), w1 = ld_u32(vr + 16);
          mma_s8(m1, pa[kk], w0 ^ 0x80808080u, w1 ^ 0x80808080u);
          mma_s8(m2, pa[kk], w0 & 0x0f0f0f0fu, w1 & 0x0f0f0f0fu);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int i = j >> 1;
          float f1 = ps_s[i] * (static_cast<float>(m1[j]) + 128.f * psum[i]);
          float f2 = ps_s[i] * static_cast<float>(m2[j]);
          st.acc[nt][j] = st.acc[nt][j] * alpha[i] + pz[i] + (f1 - f2) * 0.0625f;
          st.acc[nt + NT_K][j] = st.acc[nt + NT_K][j] * alpha[i] + pz[i] + f2;
        }
      }
      continue;
    }
    qk_tile(s, qa, Ks, gid, tig);
    if (!is_tail) fold_scores(s, qs, ksc, kzc, tig, scale);
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int cl = nt * 8 + tig * 2 + (j & 1);
        bool ok;
        if (is_tail)
          ok = c0 + cl < tail_len + ((j >> 1) ? qi_hi : qi_lo) + 1 && cl < n;
        else
          ok = rh[cl] == hg;
        s[nt][j] = ok ? (is_tail ? s[nt][j] * scale : s[nt][j]) : -INFINITY;
      }
    }
    st.update(s, Vs, gid, tig);
  }
  if (active) write_partial(st, part_acc, part_ml, hg, split, S, R, r_lo, gid, tig, any_tile);
}

}  // namespace kvz
