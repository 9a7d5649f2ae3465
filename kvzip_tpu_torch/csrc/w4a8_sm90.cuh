// The Hopper body of the W4A8 linears: K8 (w4a8.cu, the v2 storage), K15
// and K16 (w4a8_v1.cu, the v1 storage, K16 with a bias), and the unit of
// K12's four products (w4a8_fused.cu).
//
// Storage of one layer's weight: bytes (IN, OUT/2) split-packed along OUT
// (byte column j holds output column j in the high nibble and j + OUT/2 in
// the low nibble) and stored XOR 0x80, with a bf16 scale and zero per
// (nibble half, group of 128 input rows, byte column). The scale source
// says where the rows of one group lie and how to read them:
// - v2 (FOLDED): s2/z2 (2, Gp8, OUT/2), the high half pre-folded as
//   s_hi / 16 and z_hi + 8 s_hi; a unit un-primes them in float32 (s * 16
//   is exact, z - 8 s once);
// - v1: s/z (Gp, OUT), one scale and zero per output column, not folded:
//   the high nibble's are s[g, j], z[g, j], the low one's s[g, OUT/2 + j];
//   a unit takes them as they are, as the plain version expands them.
// Activations round per token to s8 (ops/quant.py::quantize_act_int8:
// amax / 127 + 1e-8, round half to even).
//
//   out[t, j] = xs[t] * sum_g (s[g, j] * sum_{k in g} xq[t, k] n[k, j]
//                              + z[g, j] * sum_{k in g} xq[t, k])  (+ bias[j])
//
// Bound on the H100: device-memory bytes at decode (T = 1 reads every
// weight byte for 2 operations per nibble); s8 tensor-core operations
// toward the 511 rows the dispatch sends here at most.
//
// Design:
// - A unit is one group of 128 input rows of an output block: 128 byte
//   columns (256 outputs) x a block of 8 NT tokens, 16 KB of weight. An
//   item is a block over one of S runs of gps groups (split-K); items are
//   numbered split-major, blocks column-major, and CTA c of the grid (OCC
//   CTAs an SM) takes items c, c + grid, ...: the CTAs at work together
//   read the same input rows across the column blocks, whole rows at a
//   time, which device memory serves faster than each CTA walking its own
//   column strip down the rows (a stream-K grid read gate/up and the
//   lm_head slower than a dp4a kernel of 1,056 small CTAs; blocks read 512
//   contiguous bytes a row did no better). The plan (ops/w4a8_v2.py::plan)
//   picks S for the fewest units of the busiest CTA, counting an item's
//   end (its partial and count) as one. Only the G = IN / 128 true groups
//   are read: pad groups (v1's INp > IN, s = z = 0) add exactly 0.
// - A ring of NS stages a CTA on mbarriers, each stage one TMA box of the
//   weight (128 rows x 128 bytes, the 128-byte swizzle, conflict-free for
//   ldmatrix) and bulk copies of the unit's four scale rows (and at T > 4
//   of the activations and their sums).
// - Tensor cores at every T (unit_mma): mma.sync m16n8k32 s8 with the
//   weights as A (16 rows: the high and low nibbles of 8 byte columns) and
//   the tokens as B (8 a tile). A warp owns 16 byte columns of the box;
//   ldmatrix.trans reads four 8-row x 16-byte blocks and a byte permutation
//   gives each lane the bytes of one column at four input rows, k in the
//   order (2t, 2t + 1, 2t + 8, 2t + 9) of each 16; the activations are
//   stored permuted alike (perm16), so B comes from ldmatrix unchanged.
//   Nibbles by masks (XOR 8 undoes the stored bias of the high one); sums
//   exact in int32 within a group, then scaled in float32 per group
//   (unit_scale).
// - Activations: at T <= 4 every CTA reads the rows (from L2), takes each
//   token's amax and quantizes the groups its units use into shared
//   memory, so the call is one launch; above, a first small kernel writes
//   the quantized rows (permuted), the scales and the group sums.
// - The one launch (T <= 4) is a programmatic dependent launch: its CTAs
//   may start while the kernel before it ends and ask for their first
//   weight boxes then; griddepcontrol.wait comes before x is read or
//   anything is written. A decode step's back-to-back linears so overlap
//   each one's ramp with the tail of the one before (on the H100, K15's
//   seven v1 linears at T 1 took 0.085 ms instead of 0.095).
// - Two CTAs an SM (four stages each) where the weight bytes bound the
//   call (T <= 16) and shared memory allows, else one with eight: the
//   second CTA streams while the first waits at an item's end
//   (tools/w4a8_stamps.py stamps each CTA's phases).
// - No finish kernel: with S > 1 an item writes a float32 partial and
//   counts itself on its block's count (release); the CTA whose count
//   reaches S adds the block's partials in split order, applies the token
//   scale, writes bf16 (then adds the bias and rounds again, as the
//   reference adds a bias to the bf16 product) and zeroes the count
//   (replayable in a CUDA graph; two calls give the same bits). With S = 1
//   an item writes its block.
//
// Everything here has internal linkage: each kernel library that includes
// the header gets its own launcher and its own shared-memory limit (a
// function-local static of an inline function is one object for every
// library of the process).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace k8 {
namespace {

typedef __nv_bfloat16 bf16;
constexpr int GROUP = 128;               // input rows a group (one scale)
constexpr int NW = 8, NTHR = NW * 32;
constexpr int CB = 128;                  // byte columns a box (16 a warp)
constexpr int WSTAGE = 16384;            // a stage's weight bytes
constexpr int SCALES = 4 * CB * 2;       // a stage's scale rows: [4][CB] bf16
constexpr int MAX_PARTS = 16;            // partials a block's merge loads at once
constexpr int INQ_T = 4;                 // tokens quantized inside the launch, at most
constexpr int SMEM_MAX = 232448 - 1024;  // the card's 227 KB less the static arrays

// NT 8-token tiles a block, NS stages, INQ: the activations quantized
// inside the launch.
template <int NT, int NS, bool INQ>
struct Cfg {
  static constexpr int TB = 8 * NT;                       // tokens a block
  static constexpr int OFF_SC = WSTAGE;                   // the unit's scales
  static constexpr int OFF_X = OFF_SC + SCALES;           // two launches: TB x 128 s8 (swizzled)
  static constexpr int OFF_XS = OFF_X + TB * GROUP;       // TB group sums
  // a stage (1,024-byte aligned, as the 128-byte swizzle wants), the ring
  // and its alignment slack
  static constexpr int STG = ((INQ ? OFF_X : OFF_XS + TB * 4) + 1023) / 1024 * 1024;
  static constexpr int RING = NS * STG;
  static constexpr int SMEM = RING + 1024;
};

#ifdef K8_STAMPS
// tools/w4a8_stamps.py: %globaltimer at each CTA's phases (start, rows
// quantized, first unit landed, last unit computed, end), 8 a CTA
__device__ unsigned long long* k8_stamps;
__device__ __forceinline__ void stamp(int cta, int phase) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0) k8_stamps[cta * 8 + phase] = t;
}
#else
__device__ __forceinline__ void stamp(int, int) {}
#endif

struct Args {
  const bf16* x;        // (T, IN)
  const int8_t* xq;     // two launches: (T, IN) s8, each 16 permuted
  const float* xs;      // two launches: (T,) token scales
  const int* xsum;      // two launches: (G, Tp) group sums
  const bf16* s;        // the layer's scales and zeros: row (half h, group g) at
  const bf16* z;        //   h * s_hs + g * s_gs
  const bf16* bias;     // (2 half,) or null
  bf16* out;            // (T, 2 half)
  float* part;          // (S n_tb n_cb, TB, 2 CB) partials, one an item (S > 1)
  unsigned* tickets;    // (n_tb n_cb,) zero between launches
  int T, IN, half, G, n_cb, n_tb, Tp, gps, S;
  long long s_hs, s_gs;
};

// Nibbles of four bytes as s8: the high ones (their stored bias undone) and
// the low ones.
__device__ __forceinline__ uint32_t nib_hi(uint32_t u) {
  return ((u >> 4) & 0x0f0f0f0fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t nib_lo(uint32_t u) { return u & 0x0f0f0f0fu; }

// An int32 sum (|c| < 2^22) to float through 2^23 + 2^22 + c: an integer
// add and a float add instead of the slow conversion.
__device__ __forceinline__ float i2f(int c) {
  return __int_as_float(c + 0x4B400000) - 12582912.f;
}

// 16 s8 values n[0..15] (in input order) packed in the units' order:
// position 4t + i of the 16 holds element 2t + (i & 1) + 8 (i >> 1).
__device__ __forceinline__ uint4 perm16(const int (&n)[16]) {
  uint32_t wd[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t word = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word |= (static_cast<uint32_t>(n[2 * t + (i & 1) + 8 * (i >> 1)]) & 0xffu) << (8 * i);
    wd[t] = word;
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// 16 activations (two 16-byte vectors of bf16) rounded to s8 by the token's
// scale s (r = 1 / s), stored in the units' order (perm16). Returns their
// sum.
__device__ __forceinline__ int quant16(const uint4 v[2], float s, float r, uint4& q) {
  const bf16* e = reinterpret_cast<const bf16*>(v);
  int n[16], sum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    n[i] = static_cast<int>(
        fminf(fmaxf(rintf(sm90::div_rn(__bfloat162float(e[i]), s, r)), -127.f), 127.f));
    sum += n[i];
  }
  q = perm16(n);
  return sum;
}

// The largest |x| of each of the first nt rows (nt <= INQ_T) of x (rows of
// n8 16-byte vectors), reduced over the CTA into red[0..nt). A thread has
// RB vectors of a row in flight at once (the rows come from L2).
__device__ __forceinline__ void row_amax(const bf16* x, int nt, int n8, float* red, int tid) {
  constexpr int RB = 8;
  float m[INQ_T] = {0.f, 0.f, 0.f, 0.f};
  for (int v0 = tid; v0 < n8; v0 += RB * NTHR) {
#pragma unroll
    for (int t = 0; t < INQ_T; ++t) {
      if (t >= nt) break;
      uint4 u[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int v = v0 + i * NTHR;
        u[i] = v < n8 ? __ldg(reinterpret_cast<const uint4*>(x) + static_cast<size_t>(t) * n8 + v)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          m[t] = fmaxf(m[t], fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
  }
  __shared__ float wred[NW][INQ_T];
#pragma unroll
  for (int t = 0; t < INQ_T; ++t) {
    float y = m[t];
#pragma unroll
    for (int o = 16; o; o >>= 1) y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, o));
    if ((tid & 31) == 0) wred[tid >> 5][t] = y;
  }
  __syncthreads();
  if (tid < nt) {
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) y = fmaxf(y, wred[w][tid]);
    red[tid] = y;
  }
  __syncthreads();
}

// Two launches, the first: one CTA a token quantizes its row into xq
// (permuted), its scale into xs and its group sums into xsum (G, Tp).
__global__ void __launch_bounds__(NTHR) act_quant_kernel(const bf16* __restrict__ x,
                                                         int8_t* __restrict__ xq,
                                                         float* __restrict__ xs,
                                                         int* __restrict__ xsum, int IN, int Tp) {
  __shared__ float amax[1];
  const int t = blockIdx.x, tid = threadIdx.x;
  const bf16* row = x + static_cast<size_t>(t) * IN;
  row_amax(row, 1, IN / 8, amax, tid);
  const float s = amax[0] / 127.0f + 1e-8f, r = 1.f / s;
  if (tid == 0) xs[t] = s;
  const int n16 = IN / 16;  // a multiple of 8: every unit of a group in one warp
  for (int u0 = 0; u0 < n16; u0 += NTHR) {
    const int u = u0 + tid;
    int sum = 0;
    if (u < n16) {
      uint4 v[2], q;
      v[0] = __ldg(reinterpret_cast<const uint4*>(row) + 2 * u);
      v[1] = __ldg(reinterpret_cast<const uint4*>(row) + 2 * u + 1);
      sum = quant16(v, s, r, q);
      reinterpret_cast<uint4*>(xq + static_cast<size_t>(t) * IN)[u] = q;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    if (u < n16 && (u & 7) == 0) xsum[static_cast<size_t>(u >> 3) * Tp + t] = sum;
  }
}

// The products of one unit: the stage's 128 x 128 weight box (A) against NT
// 8-token tiles of the group's activations (B: bptr(nt, kp) is this lane's
// ldmatrix address of tile nt for k-steps 2 kp and 2 kp + 1), into the
// int32 sums c[e][nt] of byte columns col + e (col = 16 warp + 2 (lane / 4)).
template <int NT, class BPtr>
__device__ __forceinline__ void unit_mma(const uint8_t* stg, int warp, int lane, const BPtr& bptr,
                                         int (&c)[2][NT][4]) {
#pragma unroll
  for (int kp = 0; kp < 2; ++kp) {  // k-steps 2 kp, 2 kp + 1 (32 rows each)
    uint32_t b[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sm90::ldsm_x4(b[nt], bptr(nt, kp));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ks = 2 * kp + h;
      uint32_t r[4];
      sm90::ldsm_x4_t(r, stg + (32 * ks + lane) * CB + ((warp ^ (lane & 7)) << 4));
      const uint32_t e0 = __byte_perm(r[0], r[1], 0x6420), o0 = __byte_perm(r[0], r[1], 0x7531);
      const uint32_t e1 = __byte_perm(r[2], r[3], 0x6420), o1 = __byte_perm(r[2], r[3], 0x7531);
      const uint32_t ae[4] = {nib_hi(e0), nib_lo(e0), nib_hi(e1), nib_lo(e1)};
      const uint32_t ao[4] = {nib_hi(o0), nib_lo(o0), nib_hi(o1), nib_lo(o1)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sm90::mma_s8(c[0][nt], ae, b[nt][2 * h], b[nt][2 * h + 1]);
        sm90::mma_s8(c[1][nt], ao, b[nt][2 * h], b[nt][2 * h + 1]);
      }
    }
  }
}

// One group's scales applied: f += sum * s + sum(x) * z for the high and
// the low nibble of byte columns col, col + 1, the stage's scale rows
// [s_hi, z_hi, s_lo, z_lo][CB] un-primed where FOLDED (v2); xsum(nt) gives
// the group sums of tokens nt * 8 + 2 (lane % 4) and the next one as
// floats. c is zeroed for the next group.
template <int NT, bool FOLDED, class XSum>
__device__ __forceinline__ void unit_scale(const uint8_t* stg, int col, const XSum& xsum,
                                           int (&c)[2][NT][4], float (&f)[2][NT][4]) {
  const bf16* sc = reinterpret_cast<const bf16*>(stg + WSTAGE) + col;
  const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc));
  const float2 zh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + CB));
  const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + 2 * CB));
  const float2 zl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + 3 * CB));
  float s_hi[2] = {sh.x, sh.y}, z_hi[2] = {zh.x, zh.y};
  if constexpr (FOLDED) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s_hi[e] *= 16.f;
      z_hi[e] -= 8.f * s_hi[e];
    }
  }
  const float s_lo[2] = {sl.x, sl.y}, z_lo[2] = {zl.x, zl.y};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 xs = xsum(nt);
    const float xs0 = xs.x, xs1 = xs.y;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      f[e][nt][0] += i2f(c[e][nt][0]) * s_hi[e] + xs0 * z_hi[e];
      f[e][nt][1] += i2f(c[e][nt][1]) * s_hi[e] + xs1 * z_hi[e];
      f[e][nt][2] += i2f(c[e][nt][2]) * s_lo[e] + xs0 * z_lo[e];
      f[e][nt][3] += i2f(c[e][nt][3]) * s_lo[e] + xs1 * z_lo[e];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[e][nt][j] = 0;
    }
  }
}

// Bulk copies of a unit's four scale rows (s_hi, z_hi, s_lo, z_lo of ncol
// byte columns, the high half's at element row, the low half's hs further)
// into the stage, counted on bar.
__device__ __forceinline__ void load_scales(uint8_t* stg, const bf16* s, const bf16* z,
                                            long long hs, long long row, int ncol, uint64_t* bar) {
#pragma unroll
  for (int arr = 0; arr < 4; ++arr)
    sm90::bulk_load(stg + WSTAGE + arr * (CB * 2), (arr & 1 ? z : s) + ((arr >> 1) * hs + row),
                    ncol * 2, bar);
}

// Two outputs rounded to bf16; with a bias, each then added to its bias
// value and rounded again.
__device__ __forceinline__ __nv_bfloat162 out2(float v0, float v1, const bf16* bias) {
  __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
  if (bias != nullptr) {
    const float2 yf = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(yf.x + __bfloat162float(bias[0]), yf.y + __bfloat162float(bias[1]));
  }
  return y;
}

template <int NT, int NS, int OCC, bool INQ, bool FOLDED>
__global__ void __launch_bounds__(NTHR, OCC)
    w4a8_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                const Args a) {
  using C = Cfg<NT, NS, INQ>;
  constexpr int TB = C::TB, STG = C::STG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[NS];
  __shared__ float s_xs[INQ_T];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int G = a.G, half = a.half, cta = blockIdx.x, grid = gridDim.x;
  const int n_out = a.n_tb * a.n_cb, n_items = n_out * a.S;
  // Item j: block j % n_out over the groups of split j / n_out; this CTA's
  // items are cta, cta + grid, ... (item m of the CTA: j = cta + m grid).
  auto g0_of = [&](int j) { return (j / n_out) * a.gps; };
  auto ng_of = [&](int j) { return min(G - g0_of(j), a.gps); };
  const int n_item = (n_items - cta + grid - 1) / grid;
  int n_my = 0;  // units
  for (int m = 0; m < n_item; ++m) n_my += ng_of(cta + m * grid);
  // At T <= 4: the groups of this CTA's items, item m's group gi in slot
  // m gps + gi, quantized for each token (rows of NG x 128 + 16 bytes),
  // their sums, and a zero row.
  const int NG = n_item * a.gps, xrow = NG * GROUP + 16;
  int8_t* xbuf = reinterpret_cast<int8_t*>(smem + C::RING);
  int* xsum_s = reinterpret_cast<int*>(xbuf + a.T * xrow);
  const uint8_t* zero16 = reinterpret_cast<const uint8_t*>(xsum_s + (a.T * NG + 3) / 4 * 4);

  stamp(cta, 0);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 loads the CTA's unit k, group g of item j (block o = column
  // block cb x token block tb), into a stage: the weight box by TMA, the
  // scale rows and (two launches) the group's activations and their sums.
  auto load = [&](int k, int j, int g) {
    const int o = j % n_out, cb = o / a.n_tb, tb = o % a.n_tb;
    uint8_t* stg = smem + (k % NS) * STG;
    uint64_t* bar = &full[k % NS];
    const int ncol = min(CB, half - cb * CB);
    sm90::mbar_expect_tx(bar, WSTAGE + 4 * ncol * 2 + (INQ ? 0 : TB * (GROUP + 4)));
    sm90::tma_load_2d(stg, &wmap, bar, cb * CB, g * GROUP);
    load_scales(stg, a.s, a.z, a.s_hs, g * a.s_gs + cb * CB, ncol, bar);
    if constexpr (!INQ) {
      sm90::tma_load_2d(stg + C::OFF_X, &xmap, bar, g * GROUP, tb * TB);
      sm90::bulk_load(stg + C::OFF_XS, a.xsum + static_cast<size_t>(g) * a.Tp + tb * TB, TB * 4,
                      bar);
    }
  };
  int lk = 0, lj = cta, lgi = 0;  // thread 0's next load: unit lk, item lj's group lgi
  auto load_next = [&]() {
    load(lk++, lj, g0_of(lj) + lgi);
    if (++lgi == ng_of(lj)) {
      lgi = 0;
      lj += grid;
    }
  };
  if (tid == 0)
    while (lk < min(n_my, NS - 1)) load_next();

  if constexpr (INQ) {
    // Launched as a programmatic dependent (one launch, T <= 4): the weights
    // above are read while the kernel before this one ends; nothing it wrote
    // (x) is read, and nothing is written, before it has completed. The
    // next kernel may start its own weight reads once every CTA is here.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    // Every token's scale from its whole row; then the CTA's groups
    // quantized into xbuf (8 threads a group, 16 activations each), with
    // their sums.
    row_amax(a.x, a.T, a.IN / 8, s_xs, tid);
    if (tid < INQ_T) s_xs[tid] = tid < a.T ? s_xs[tid] / 127.0f + 1e-8f : 1.f;
    if (tid < 4) reinterpret_cast<uint32_t*>(const_cast<uint8_t*>(zero16))[tid] = 0u;
    __syncthreads();
    const int units = a.T * NG * 8;
    for (int u0 = 0; u0 < units; u0 += NTHR) {
      const int u = u0 + tid, t = u / (NG * 8), sl = (u / 8) % NG, piece = u % 8;
      const int it = cta + (sl / a.gps) * grid, gi = sl % a.gps;
      const bool on = u < units && gi < ng_of(it);
      int sum = 0;
      if (on) {
        const uint4* src = reinterpret_cast<const uint4*>(
            a.x + static_cast<size_t>(t) * a.IN + (g0_of(it) + gi) * GROUP + piece * 16);
        const uint4 v[2] = {__ldg(src), __ldg(src + 1)};
        const float s = s_xs[t];
        uint4 q;
        sum = quant16(v, s, 1.f / s, q);
        *reinterpret_cast<uint4*>(xbuf + t * xrow + sl * GROUP + piece * 16) = q;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (on && piece == 0) xsum_s[t * NG + sl] = sum;
    }
  }
  stamp(cta, 1);

  // c: a unit's int32 sums, f: the block's float32 sums; [column e]
  int c[2][NT][4];
  float f[2][NT][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[e][nt][j] = 0;
        f[e][nt][j] = 0.f;
      }
  const int col = warp * 16 + 2 * gid;  // this lane's byte columns col, col + 1 of the box

  int m = 0, gi = 0;  // the unit computed: the CTA's item m, its group gi
  for (int k = 0; k < n_my; ++k) {
    sm90::mbar_wait(&full[k % NS], (k / NS) & 1);
    if (k == 0) stamp(cta, 2);
    __syncthreads();  // unit k landed; every warp is done with unit k - 1
    if (tid == 0 && lk < n_my) load_next();
    const uint8_t* stg = smem + (k % NS) * STG;
    const int it = cta + m * grid, o = it % n_out, cb = o / a.n_tb, tb = o % a.n_tb,
              slot = m * a.gps + gi;

    // B: tokens nt * 8 + (lane & 7), 16-byte block lane >> 3 of the pair
    unit_mma<NT>(stg, warp, lane, [&](int nt, int kp) -> const uint8_t* {
      const int t = nt * 8 + (lane & 7);
      if constexpr (INQ)
        return t < a.T ? reinterpret_cast<const uint8_t*>(xbuf) + t * xrow + slot * GROUP +
                             kp * 64 + (lane >> 3) * 16
                       : zero16;
      else  // the activation box's 128-byte swizzle: chunk ^ (row % 8)
        return stg + C::OFF_X + t * GROUP + (((kp * 4 + (lane >> 3)) ^ (lane & 7)) << 4);
    }, c);
    unit_scale<NT, FOLDED>(stg, col, [&](int nt) -> float2 {
      const int t0 = nt * 8 + 2 * tig;
      float2 r;
      if constexpr (INQ) {
        r.x = t0 < a.T ? static_cast<float>(xsum_s[t0 * NG + slot]) : 0.f;
        r.y = t0 + 1 < a.T ? static_cast<float>(xsum_s[(t0 + 1) * NG + slot]) : 0.f;
      } else {
        r.x = static_cast<float>(*reinterpret_cast<const int*>(stg + C::OFF_XS + t0 * 4));
        r.y = static_cast<float>(*reinterpret_cast<const int*>(stg + C::OFF_XS + t0 * 4 + 4));
      }
      return r;
    }, c, f);
    if (++gi < ng_of(it)) continue;
    if (k == n_my - 1) stamp(cta, 3);

    // The item's end. Element j of f[e][nt] is token nt * 8 + 2 tig + (j & 1)
    // of output column (j >> 1) * half + cb * CB + col + e.
    const bool col_ok = cb * CB + col < half;
    auto token_scale = [&](int t) { return INQ ? s_xs[t] : __ldg(a.xs + tb * TB + t); };
    auto bias_at = [&](int j) { return a.bias != nullptr ? a.bias + j : nullptr; };
    if (a.S == 1) {  // the whole block
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = nt * 8 + 2 * tig + (j & 1), tok = tb * TB + t;
          if (tok < a.T && col_ok) {
            const float sx = token_scale(t);
            const int oc = (j >> 1) * half + cb * CB + col;
            *reinterpret_cast<__nv_bfloat162*>(a.out + static_cast<size_t>(tok) * 2 * half + oc) =
                out2(f[0][nt][j] * sx, f[1][nt][j] * sx, bias_at(oc));
          }
        }
    } else {
      // the item's partial: [token][half][CB]
      float* p = a.part + static_cast<size_t>(it) * TB * 2 * CB;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = nt * 8 + 2 * tig + (j & 1);
          if (tb * TB + t < a.T)
            *reinterpret_cast<float2*>(p + t * 2 * CB + (j >> 1) * CB + col) =
                make_float2(f[0][nt][j], f[1][nt][j]);
        }
      __syncthreads();  // the CTA's partial is written
      if (tid == 0) {
        sm90::fence_acq_rel();
        const unsigned prev = sm90::atom_add(a.tickets + o, 1u);
        s_last = prev == static_cast<unsigned>(a.S - 1);
        if (s_last) {
          a.tickets[o] = 0u;
          sm90::fence_acq_rel();
        }
      }
      __syncthreads();
      if (s_last) {  // add the partials in split order, MAX_PARTS loads at once
        const int t_n = min(TB, a.T - tb * TB);
        for (int u = tid; u < t_n * (2 * CB / 4); u += NTHR) {  // (token, 4 columns)
          const int t = u / (2 * CB / 4), q = (u % (2 * CB / 4)) * 4, hl = q / CB, cq = q % CB;
          if (cb * CB + cq >= half) continue;
          const size_t at = static_cast<size_t>(t) * 2 * CB + q;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int s0 = 0; s0 < a.S; s0 += MAX_PARTS) {
            float4 v[MAX_PARTS];
#pragma unroll
            for (int n = 0; n < MAX_PARTS; ++n)
              if (s0 + n < a.S)
                v[n] = __ldcg(reinterpret_cast<const float4*>(
                    a.part + static_cast<size_t>((s0 + n) * n_out + o) * TB * 2 * CB + at));
#pragma unroll
            for (int n = 0; n < MAX_PARTS; ++n)
              if (s0 + n < a.S) {
                acc.x += v[n].x;
                acc.y += v[n].y;
                acc.z += v[n].z;
                acc.w += v[n].w;
              }
          }
          const float sx = token_scale(t);
          const int oc = hl * half + cb * CB + cq;
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
              a.out + static_cast<size_t>(tb * TB + t) * 2 * half + oc);
          dst[0] = out2(acc.x * sx, acc.y * sx, bias_at(oc));
          dst[1] = out2(acc.z * sx, acc.w * sx, bias_at(oc + 2));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) f[e][nt][i] = 0.f;
    gi = 0;
    ++m;
  }
  stamp(cta, 4);
}

// The kernel's dynamic shared-memory limit is raised to the largest size
// launched so far on the device (the first launch at a size must not be
// inside a CUDA-graph capture).
template <int NT, int NS, int OCC, bool INQ, bool FOLDED>
int launch(const CUtensorMap& wmap, const CUtensorMap& xmap, const Args& a, int grid, int smem,
           cudaStream_t st) {
  static int limit[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > limit[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(w4a8_kernel<NT, NS, OCC, INQ, FOLDED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NTHR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = INQ ? 1 : 0;  // one launch: its weight reads may overlap the kernel before
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w4a8_kernel<NT, NS, OCC, INQ, FOLDED>, wmap, xmap, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One call: x (T, IN) bf16; w the layer's bytes (at least IN rows of OUT/2,
// of which the first IN are read); s/z the layer's scales, the row of
// (half h, group g) at h s_hs + g s_gs elements; bias (OUT,) or null; out
// (T, OUT) bf16. The plan (ops/w4a8_v2.py::plan): nt (8-token tiles a
// block: 1, 2, 4 or 8), occ (CTAs an SM: 2 at nt <= 2, with four stages
// each, else 1 with eight), inq (1: one launch, T <= 4), gps (groups an
// item), S (splits), grid. Scratch: part (S n_tb n_cb, 8 nt, 256) f32
// (S > 1); tickets (n_tb n_cb,) zero before the first launch (each launch
// leaves them zero); two launches only: xq (T, IN) s8, xs (T,) f32, xsum
// (IN / 128, Tp) int32 with Tp = n_tb 8 nt.
template <bool FOLDED>
int run(const void* x, const void* w, const void* s, const void* z, const void* bias, void* out,
        void* part, void* tickets, void* xq, void* xs, void* xsum, int T, int IN, int OUT,
        long long s_hs, long long s_gs, int nt, int occ, int inq, int gps, int S, int grid,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.xq = static_cast<const int8_t*>(xq);
  a.xs = static_cast<const float*>(xs);
  a.xsum = static_cast<const int*>(xsum);
  a.s = static_cast<const bf16*>(s);
  a.z = static_cast<const bf16*>(z);
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned*>(tickets);
  a.T = T;
  a.IN = IN;
  a.half = OUT / 2;
  a.G = IN / GROUP;
  a.n_cb = (a.half + CB - 1) / CB;
  a.n_tb = (T + 8 * nt - 1) / (8 * nt);
  a.Tp = a.n_tb * 8 * nt;
  a.gps = gps;
  a.S = S;
  a.s_hs = s_hs;
  a.s_gs = s_gs;
  if (IN % GROUP || a.half % 16 || gps < 1 || S != (a.G + gps - 1) / gps || grid < 1 ||
      grid > a.n_tb * a.n_cb * S || (occ != 1 && occ != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  // the weight slice (IN rows of half bytes) in boxes of 128 x 128 bytes and
  // the quantized activations (T rows of IN bytes) in boxes of 8 nt x 128,
  // both with the 128-byte swizzle
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(a.half), static_cast<cuuint64_t>(IN)};
  const cuuint64_t wstr[1] = {static_cast<cuuint64_t>(a.half)};
  const cuuint32_t wbox[2] = {CB, GROUP};
  if (!sm90::tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_128B, w, 2,
                        wdims, wstr, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  xmap = wmap;
  if (inq) {
    const int ng = (a.n_tb * a.n_cb * S + grid - 1) / grid * gps;  // the CTA's group slots
    const int rows = T * (ng * GROUP + 16) + (T * ng + 3) / 4 * 16 + 16;
    if (nt != 1 || T > INQ_T) return static_cast<int>(cudaErrorInvalidValue);
    if (occ == 2) {
      const int smem = Cfg<1, 4, true>::SMEM + rows;
      if (2 * smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
      return launch<1, 4, 2, true, FOLDED>(wmap, xmap, a, grid, smem, st);
    }
    const int smem = Cfg<1, 6, true>::SMEM + rows;
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    return launch<1, 6, 1, true, FOLDED>(wmap, xmap, a, grid, smem, st);
  }
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(IN), static_cast<cuuint64_t>(T)};
  const cuuint64_t xstr[1] = {static_cast<cuuint64_t>(IN)};
  const cuuint32_t xbox[2] = {GROUP, static_cast<cuuint32_t>(8 * nt)};
  if (!sm90::tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_128B, xq, 2,
                        xdims, xstr, xbox))
    return static_cast<int>(cudaErrorInvalidValue);
  act_quant_kernel<<<T, NTHR, 0, st>>>(a.x, static_cast<int8_t*>(xq), static_cast<float*>(xs),
                                       static_cast<int*>(xsum), IN, a.Tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ == 2 && nt == 1)
    return launch<1, 4, 2, false, FOLDED>(wmap, xmap, a, grid, Cfg<1, 4, false>::SMEM, st);
  if (occ == 2 && nt == 2)
    return launch<2, 4, 2, false, FOLDED>(wmap, xmap, a, grid, Cfg<2, 4, false>::SMEM, st);
  switch (nt) {
    case 1: return launch<1, 8, 1, false, FOLDED>(wmap, xmap, a, grid, Cfg<1, 8, false>::SMEM, st);
    case 2: return launch<2, 8, 1, false, FOLDED>(wmap, xmap, a, grid, Cfg<2, 8, false>::SMEM, st);
    case 4: return launch<4, 8, 1, false, FOLDED>(wmap, xmap, a, grid, Cfg<4, 8, false>::SMEM, st);
    case 8: return launch<8, 8, 1, false, FOLDED>(wmap, xmap, a, grid, Cfg<8, 8, false>::SMEM, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace k8
