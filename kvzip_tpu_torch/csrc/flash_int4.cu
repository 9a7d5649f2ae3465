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
// Bound on the H100: tensor-core operations at prefill and scoring shapes;
// device-memory bytes at decode (T <= 16), where the int4 rows are 3.8x
// fewer bytes than bf16 rows.
// Design: K1's structure (one CTA per (kv head, block of queries), the GQA
// group packed as G * BQ rows, one warp per 16 rows, every K/V tile shared
// by the group out of shared memory). The loader expands each packed tile
// in shared memory: K to exact nibble values with the scale and zero folded
// in float32 after the product, V to dequantized bf16 (int4_common.cuh).
// Decode (T <= 16) runs K4's flash-decoding instead: the G * T rows pack
// into 64-row CTAs, the keys split over many CTAs, and a merge kernel
// combines the partials, so a handful of queries still fills the card.
#include "int4_common.cuh"

using namespace kvz;

// One int4 key source: its packed rows and per-row scales/zeros, rows
// strided by `stride` bytes (scales by `sstride` elements).
struct Int4Src {
  const uint8_t* kq;
  const bf16* ks;
  const bf16* kz;
  const uint8_t* vq;
  const bf16* vs;
  const bf16* vz;
  size_t stride;
  size_t sstride;
};

// One online-softmax step over the int4 rows [c0, c0 + n) of src, with
// visibility col < lim[i] for the warp's two rows (col counted from the
// start of src).
__device__ __forceinline__ void int4_step(Online& st, const uint32_t qa[KK_D][4], const float qs[2],
                                          const Int4Src& src, int c0, int n, const int lim[2],
                                          bf16* Ks, bf16* Vs, float* ksc, float* kzc, int tid,
                                          int nthr, int gid, int tig, float scale, bool active) {
  __syncthreads();
  load_tile_int4<false>(Ks, ksc, kzc, src.kq, src.stride, src.ks, src.kz, src.sstride, c0, n, tid,
                        nthr);
  load_tile_int4<true>(Vs, nullptr, nullptr, src.vq, src.stride, src.vs, src.vz, src.sstride, c0, n,
                       tid, nthr);
  __syncthreads();
  if (!active) return;
  float s[NT_K][4];
  qk_tile(s, qa, Ks, gid, tig);
  fold_scores(s, qs, ksc, kzc, tig, scale);
#pragma unroll
  for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int cl = nt * 8 + tig * 2 + (j & 1);
      if (!(cl < n && c0 + cl < lim[j >> 1])) s[nt][j] = -INFINITY;
    }
  }
  st.update(s, Vs, gid, tig);
}

__global__ void flash_int4_kernel(const bf16* __restrict__ q, Int4Src cache, Int4Src extra,
                                  const int* __restrict__ base_lens, bf16* __restrict__ out, int T,
                                  int H, int C, int G, int wph, float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ __align__(16) bf16 Vs[BK * SROW];
  __shared__ float ksc[BK], kzc[BK];
  const int hk = blockIdx.x, qb = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int BQ = 16 * wph;
  const int g = warp / wph, sub = warp % wph;
  const int head = hk * G + g;
  const int t_lo = qb * BQ + sub * 16 + gid, t_hi = t_lo + 8;

  uint32_t qa[KK_D][4];
  load_q(qa, t_lo < T ? q + (static_cast<size_t>(t_lo) * H + head) * D : nullptr,
         t_hi < T ? q + (static_cast<size_t>(t_hi) * H + head) * D : nullptr, tig);
  float qs[2];
  q_row_sums(qa, qs);

  Online st;
  st.init();
  const bool has_extra = extra.kq != nullptr;
  const int base = base_lens[hk];
  const int q_end = min(qb * BQ + BQ, T);
  // K6: the cache rows are all visible and end at base; K5: causal
  const int kv_end = has_extra ? min(base, C) : min(base + q_end, C);
  Int4Src src = cache;
  src.kq += static_cast<size_t>(hk) * C * DP;
  src.vq += static_cast<size_t>(hk) * C * DP;
  src.ks += static_cast<size_t>(hk) * C;
  src.kz += static_cast<size_t>(hk) * C;
  src.vs += static_cast<size_t>(hk) * C;
  src.vz += static_cast<size_t>(hk) * C;
  int lim[2] = {has_extra ? kv_end : base + t_lo + 1, has_extra ? kv_end : base + t_hi + 1};
  for (int c0 = 0; c0 < kv_end; c0 += BK)
    int4_step(st, qa, qs, src, c0, min(BK, kv_end - c0), lim, Ks, Vs, ksc, kzc, tid, nthr, gid,
              tig, scale, true);
  if (has_extra) {
    Int4Src x = extra;  // (T, Hkv, D/2) rows: head hk's row c at c * Hkv + hk
    x.kq += static_cast<size_t>(hk) * DP;
    x.vq += static_cast<size_t>(hk) * DP;
    x.ks += hk;
    x.kz += hk;
    x.vs += hk;
    x.vz += hk;
    int xlim[2] = {t_lo + 1, t_hi + 1};
    for (int c0 = 0; c0 < q_end; c0 += BK)
      int4_step(st, qa, qs, x, c0, min(BK, q_end - c0), xlim, Ks, Vs, ksc, kzc, tid, nthr, gid,
                tig, scale, true);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int t = i ? t_hi : t_lo;
    if (t >= T) continue;
    float den = fmaxf(st.l[i], 1e-37f);
    bf16* o = out + (static_cast<size_t>(t) * H + head) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
          __floats2bfloat162_rn(st.acc[nt][2 * i] / den, st.acc[nt][2 * i + 1] / den);
  }
}

// Decode form of K5 (T <= 16): K4's flash-decoding over the int4 cache.
__global__ void flash_int4_split_kernel(const bf16* __restrict__ q, Int4Src cache,
                                        const int* __restrict__ base_lens, float* part_acc,
                                        float* part_ml, int T, int H, int C, int G, int CH, int S,
                                        float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ __align__(16) bf16 Vs[BK * SROW];
  __shared__ float ksc[BK], kzc[BK];
  const int split = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int R = G * T;
  const int r_lo = blockIdx.z * 64 + warp * 16 + gid, r_hi = r_lo + 8;
  const bool active = blockIdx.z * 64 + warp * 16 < R;
  const int qi_lo = r_lo % T, qi_hi = r_hi % T;

  uint32_t qa[KK_D][4];
  load_q(qa, r_lo < R ? q + (static_cast<size_t>(qi_lo) * H + hk * G + r_lo / T) * D : nullptr,
         r_hi < R ? q + (static_cast<size_t>(qi_hi) * H + hk * G + r_hi / T) * D : nullptr, tig);
  float qs[2];
  q_row_sums(qa, qs);

  Online st;
  st.init();
  const int base = base_lens[hk];
  const int k0 = split * CH, k1 = min(min(k0 + CH, base + T), C);
  Int4Src src = cache;
  src.kq += static_cast<size_t>(hk) * C * DP;
  src.vq += static_cast<size_t>(hk) * C * DP;
  src.ks += static_cast<size_t>(hk) * C;
  src.kz += static_cast<size_t>(hk) * C;
  src.vs += static_cast<size_t>(hk) * C;
  src.vz += static_cast<size_t>(hk) * C;
  int lim[2] = {base + qi_lo + 1, base + qi_hi + 1};
  for (int c0 = k0; c0 < k1; c0 += BK)
    int4_step(st, qa, qs, src, c0, min(BK, k1 - c0), lim, Ks, Vs, ksc, kzc, tid, nthr, gid, tig,
              scale, active);
  if (active) write_partial(st, part_acc, part_ml, hk, split, S, R, r_lo, gid, tig, k0 < k1);
}

static Int4Src make_src(const void* kq, const void* ks, const void* kz, const void* vq,
                        const void* vs, const void* vz, size_t stride, size_t sstride) {
  return Int4Src{static_cast<const uint8_t*>(kq), static_cast<const bf16*>(ks),
                 static_cast<const bf16*>(kz), static_cast<const uint8_t*>(vq),
                 static_cast<const bf16*>(vs), static_cast<const bf16*>(vz), stride, sstride};
}

static int launch_flash(const void* q, Int4Src cache, Int4Src extra, const void* base_lens,
                        void* out, int T, int H, int Hkv, int C, float scale, void* stream) {
  int G = H / Hkv;
  int wph = G >= 8 ? 1 : 8 / G;  // warps per query head: G * wph <= 8 warps
  dim3 grid(Hkv, (T + 16 * wph - 1) / (16 * wph));
  flash_int4_kernel<<<grid, 32 * G * wph, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), cache, extra, static_cast<const int*>(base_lens),
      static_cast<bf16*>(out), T, H, C, G, wph, scale);
  return static_cast<int>(cudaGetLastError());
}

// K5. q (T, H, D) bf16; k_q/v_q (Hkv, C, D/2) uint8; k_s/k_z/v_s/v_z
// (Hkv, C) bf16; base_lens (Hkv,) int32; out (T, H, D) bf16.
extern "C" int kvz_flash_int4(const void* q, const void* kq, const void* ks, const void* kz,
                              const void* vq, const void* vs, const void* vz,
                              const void* base_lens, void* out, int T, int H, int Hkv, int C,
                              float scale, void* stream) {
  Int4Src none{};
  return launch_flash(q, make_src(kq, ks, kz, vq, vs, vz, DP, 1), none, base_lens, out, T, H, Hkv,
                      C, scale, stream);
}

// K5, decode form: as kvz_flash_int4, plus part_acc (Hkv, S, G*T, D) and
// part_ml (Hkv, S, G*T, 2) f32 scratch, S = ceil(C / CH).
extern "C" int kvz_flash_int4_decode(const void* q, const void* kq, const void* ks,
                                     const void* kz, const void* vq, const void* vs,
                                     const void* vz, const void* base_lens, void* out,
                                     void* part_acc, void* part_ml, int T, int H, int Hkv, int C,
                                     int CH, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G = H / Hkv, R = G * T, S = (C + CH - 1) / CH;
  dim3 grid(S, Hkv, (R + 63) / 64);
  flash_int4_split_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(q), make_src(kq, ks, kz, vq, vs, vz, DP, 1),
      static_cast<const int*>(base_lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), T, H, C, G, CH, S, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_partials_kernel<<<dim3(R, Hkv), D, 0, st>>>(static_cast<const float*>(part_acc),
                                                    static_cast<const float*>(part_ml),
                                                    static_cast<bf16*>(out), T, H, G, S, R);
  return static_cast<int>(cudaGetLastError());
}

// K6. As kvz_flash_int4 with nothing appended, plus the chunk's own rows:
// x_kq/x_vq (T, Hkv, D/2) uint8 and x_ks/x_kz/x_vs/x_vz (T, Hkv) bf16.
extern "C" int kvz_flash_int4_extra(const void* q, const void* kq, const void* ks,
                                    const void* kz, const void* vq, const void* vs,
                                    const void* vz, const void* base_lens, const void* x_kq,
                                    const void* x_ks, const void* x_kz, const void* x_vq,
                                    const void* x_vs, const void* x_vz, void* out, int T, int H,
                                    int Hkv, int C, float scale, void* stream) {
  return launch_flash(q, make_src(kq, ks, kz, vq, vs, vz, DP, 1),
                      make_src(x_kq, x_ks, x_kz, x_vq, x_vs, x_vz,
                               static_cast<size_t>(Hkv) * DP, Hkv),
                      base_lens, out, T, H, Hkv, C, scale, stream);
}
