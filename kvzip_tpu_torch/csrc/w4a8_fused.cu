// K12: the fused W4A8 decode layer, one launch for everything between two
// attentions.
//
// Replaces kvzip_tpu/ops/w4a8_fused.py::w4a8_layer_fused (_layer_kernel).
// For T <= 8 token rows it computes o-proj of the attention output,
// x1 = rnd(x + rnd(o)), RMSNorm (ln_mlp) and the s8 quantization, gate/up,
// h = rnd(gate * sigmoid(gate) * up), h's s8 quantization by its row
// maximum, down, x2 = rnd(x1 + rnd(dn)) (the layer's output), RMSNorm with
// the NEXT layer's ln_attn and its qkv. rnd rounds to bf16 at exactly these
// points; activation scales are s = amax / 127 + 1e-20 and the s8 values
// rint(v * (1 / s)), unclipped, as in the reference.
//
// Weights: the v2 storage of K8 (csrc/w4a8.cu): bytes (L, IN, OUT/2), output
// column j in the high nibble and j + OUT/2 in the low one, stored XOR
// 0x80; bf16 s2/z2 (L, 2, Gp8, OUT/2) with the high half pre-folded as
// s_hi / 16 and z_hi + 8 s_hi.
//
// Bound on the H100: device-memory bytes (the four weight slices and their
// scales, ~125 MB a layer at qwen2.5-7b, 0.037 ms at 3.35 TB/s).
// Design: the TPU ran one sequential grid and kept the residual row, the s8
// activations and the hidden row in VMEM. Here one persistent cooperative
// launch, every CTA resident (two an SM, the grid from the occupancy with
// the dynamic shared memory), walks eight phases separated by grid-wide
// barriers:
//   1 o-proj (every CTA quantizes the attention rows it uses from their
//     maxima, which it computes itself)    2 x1, norm, quant (CTA t: row t)
//   3 gate/up    4 SiLU*up into h and its row maxima (all CTAs, atomicMax)
//   5 down (h quantized by its maxima)     6 x2, norm, quant (CTA t: row t)
//   7 qkv        8 the qkv rows (all CTAs).
// The products run on K8's unit (w4a8_sm90.cuh): a unit is one TMA box of
// 128 input rows x 128 byte columns of the product's weight (a 3-D tensor
// map over the stack, the layer a coordinate) with its four scale rows by
// bulk copy, on a ring of NS mbarrier stages; mma.sync m16n8k32 s8 with the
// weights as A and the T <= 8 tokens as one 8-token B tile (rows past T
// read a zero row); int32 sums per group, scaled in float32 by the stored
// folded scales as the reference kernel scales them. A product's
// items are a 128-byte-column block over one of S runs of gps groups,
// numbered split-major, and CTA c takes items c, c + grid, ...
// (ops/w4a8_fused.py::plan); an item writes one float partial, and the
// phase after the barrier adds the S partials of an output in split order,
// so results do not depend on timing. Before a product each CTA quantizes
// (or copies) the groups its items use into shared memory, in the unit's
// permuted order, with their sums. One thread (PRODUCER) keeps up to NS
// units in flight as one stream over the four products: o-proj's first
// units once the attention rows are read, none of the next product's while
// the current one's are still to come (so a product's units are not read
// behind the next one's), and the next product's first NS as soon as the
// current one's last unit is done, before the barrier: no product's weights
// depend on an earlier phase, so they land while the CTA waits and the row
// phases run, and only the activations wait for them. Partials stay small
// (S <= 2 G / T: at most 1/8 of the weight bytes) and in L2. Scratch
// written in one phase and read in a later one is read with ld.global.cg
// (L2), never through L1.
// Measured on the H100 and not kept (tools/w4a8_stamps.py --k12, PERF.md):
// counting each item on its column block and merging there, as K8 does,
// with release/acquire counts instead of the barriers (every item's count
// waits for its partial to be visible, and a row step after a count is as
// long a chain of round trips as a barrier and a row phase); asking for the
// next product's units after its activations (the barriers then come 1 us
// after the last arrival instead of 3-5, but the product starts on an empty
// ring); planning splits for the busiest SM (half the CTAs at work on down).
#include <cooperative_groups.h>
#include <math.h>
#include <string.h>

#include "w4a8_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using k8::bf16;
using k8::CB;
using k8::GROUP;
using k8::NTHR;
using k8::NW;
using k8::WSTAGE;

constexpr int MAX_T = 8;
constexpr int NS = 4;                        // ring stages
constexpr int STG = 17408;                   // a stage: the weight box and its scale rows
constexpr int RING = NS * STG;
constexpr int XB_MAX = 40960;                // a product's quantized groups of one CTA and their sums
constexpr int SMEM = RING + 1024 + XB_MAX;   // dynamic, with the ring's alignment slack
constexpr int OCC = 2;                       // CTAs an SM
constexpr int MAX_SPLITS = 16;               // splits of a product's input groups
constexpr int NPROD = 4;                     // o-proj, gate/up, down, qkv
constexpr int PRODUCER = 32;                 // the thread that asks for the units

// a product's activations: the bf16 attention rows, the s8 rows xq, h
enum Src { SRC_BF16 = 0, SRC_S8 = 1, SRC_F32 = 2 };

struct Lin {  // one product: a layer's slice of a v2 weight stack
  const bf16* s2;  // (2, gp8, half), the layer's
  const bf16* z2;
  int layer;       // the weight map's layer coordinate
  int in, half, gp8, S;
};

struct Args {
  const bf16* x;        // (T, D)
  const bf16* attn;     // (T, o.in)
  const bf16* ln_mlp;   // (D,) this layer's
  const bf16* ln_attn;  // (D,) the next layer's
  Lin w[NPROD];         // o, gate/up, down, qkv
  bf16* x_new;          // (T, D)
  bf16* qkv_out;        // (T, 2 qkv.half)
  int8_t* xq;           // (T, D) s8 activations of gate/up and qkv
  float* xs;            // (T,) their scales
  int* hmax;            // (T,) h's row maxima (float bits)
  float* xrow;          // (T, D) residual row
  float* hbuf;          // (T, gu.half) h
  float* part;          // partial sums of the current product
  int T, D;
  float eps;
};

#ifdef K12_STAMPS
// tools/w4a8_stamps.py --k12: %globaltimer at each CTA's phase boundaries
// (K12_PHASES there), 24 a CTA
__device__ unsigned long long* k12_stamps;
__device__ __forceinline__ void stamp(int phase) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0) k12_stamps[blockIdx.x * 24 + phase] = t;
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// A product's geometry: its true groups, column blocks, groups a split and
// items.
__device__ __forceinline__ int groups_of(const Lin& w) { return w.in / GROUP; }
__device__ __forceinline__ int ncb_of(const Lin& w) { return (w.half + CB - 1) / CB; }
__device__ __forceinline__ int gps_of(const Lin& w) { return (groups_of(w) + w.S - 1) / w.S; }
__device__ __forceinline__ int items_of(const Lin& w) { return ncb_of(w) * w.S; }
// groups of item j (split j / ncb)
__device__ __forceinline__ int ng_of(const Lin& w, int j) {
  const int gps = gps_of(w);
  return min(groups_of(w) - (j / ncb_of(w)) * gps, gps);
}

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load4(const bf16* p, float f[4]) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

// The S splits of the partial sums at p (split stride n), loaded together
// and added in split order.
__device__ __forceinline__ float split_sum(const float* p, size_t n, int S) {
  float v[MAX_SPLITS];
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k) v[k] = k < S ? __ldcg(p + k * n) : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k) acc += v[k];
  return acc;
}

__device__ __forceinline__ float4 split_sum4(const float* p, size_t n, int S) {
  float4 v[MAX_SPLITS];
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k)
    v[k] = k < S ? __ldcg(reinterpret_cast<const float4*>(p + k * n)) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k) {
    acc.x += v[k].x;
    acc.y += v[k].y;
    acc.z += v[k].z;
    acc.w += v[k].w;
  }
  return acc;
}

__device__ __forceinline__ int quant4(float a, float b, float c, float d, float inv) {
  uint32_t w = (static_cast<uint32_t>(static_cast<int>(rintf(a * inv)) & 0xff)) |
               (static_cast<uint32_t>(static_cast<int>(rintf(b * inv)) & 0xff) << 8) |
               (static_cast<uint32_t>(static_cast<int>(rintf(c * inv)) & 0xff) << 16) |
               (static_cast<uint32_t>(static_cast<int>(rintf(d * inv)) & 0xff) << 24);
  return static_cast<int>(w);
}

// One group's scales applied as the reference kernel applies its stored
// (folded) v2 scales: f_hi += d * s2_hi + sum(x) * z2_hi with d = 16 (c_hi -
// 8 sum(x)), the exact dot of the stored bytes read as s8 less their low
// nibbles (c_hi is the dot of the true high nibbles), and f_lo += c_lo *
// s2_lo + sum(x) * z2_lo; c[e][0] holds (hi, token 2 (lane % 4)), (hi, the
// next token), (lo, token), (lo, next) of byte columns col + e, and is
// zeroed for the next group. (K8's unit_scale un-primes the scales instead:
// the same value, rounded elsewhere.)
__device__ __forceinline__ void unit_scale_folded(const uint8_t* stg, int col, int xs0, int xs1,
                                                  int (&c)[2][1][4], float (&f)[2][1][4]) {
  const bf16* sc = reinterpret_cast<const bf16*>(stg + WSTAGE) + col;
  const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc));
  const float2 zh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + CB));
  const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + 2 * CB));
  const float2 zl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + 3 * CB));
  const float s_hi[2] = {sh.x, sh.y}, z_hi[2] = {zh.x, zh.y};
  const float s_lo[2] = {sl.x, sl.y}, z_lo[2] = {zl.x, zl.y};
  const float x0 = static_cast<float>(xs0), x1 = static_cast<float>(xs1);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    f[e][0][0] += static_cast<float>(16 * (c[e][0][0] - 8 * xs0)) * s_hi[e] + x0 * z_hi[e];
    f[e][0][1] += static_cast<float>(16 * (c[e][0][1] - 8 * xs1)) * s_hi[e] + x1 * z_hi[e];
    f[e][0][2] += static_cast<float>(c[e][0][2]) * s_lo[e] + x0 * z_lo[e];
    f[e][0][3] += static_cast<float>(c[e][0][3]) * s_lo[e] + x1 * z_lo[e];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[e][0][j] = 0;
  }
}

struct Small {
  float s[MAX_T], inv[MAX_T];  // activation scales of the current product's rows
  float red[NW];               // block reductions
};

__device__ __forceinline__ float block_sum(float v, Small& sm) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) r += sm.red[w];
  return r;
}

__device__ __forceinline__ float block_max(float v, Small& sm) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) r = fmaxf(r, sm.red[w]);
  return r;
}

// Row t of a D-wide product (o-proj or down) added to the residual:
// v = rnd(base + rnd(sum of S splits * s)), base the input row x (o-proj)
// or x1 (down, which also writes the layer's output); then RMSNorm with lnw
// and the s8 quantization into xq / xs. The phase is a chain of dependent
// L2 round trips: the split sums go four columns a thread at a time; the
// row's values stay in shared memory (rowbuf, D floats) for the sum of
// squares and the two sweeps of the normalized row, which issue RC runs of
// 4 columns' ln loads together.
__device__ void row_finish(const Args& a, int t, int S, float s, const bf16* lnw, bool down,
                           float* rowbuf, Small& sm) {
  constexpr int RC = 4;
  const int D = a.D, tid = threadIdx.x;
  const size_t n = static_cast<size_t>(a.T) * D, row = static_cast<size_t>(t) * D;
  float* xr = a.xrow + row;
  for (int c = tid * 4; c < D; c += NTHR * 4) {
    float base[4], v[4];
    if (down) {
      const float4 b = __ldcg(reinterpret_cast<const float4*>(xr + c));
      base[0] = b.x, base[1] = b.y, base[2] = b.z, base[3] = b.w;
    } else {
      load4(a.x + row + c, base);
    }
    const float4 acc = split_sum4(a.part + row + c, n, S);
    const float ac[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = rnd(base[j] + rnd(ac[j] * s));
    *reinterpret_cast<float4*>(xr + c) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(rowbuf + c) = make_float4(v[0], v[1], v[2], v[3]);
    if (down) {
      __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(a.x_new + row + c) = *reinterpret_cast<const uint2*>(h);
    }
  }
  // The sum of squares in a fixed order: 128 threads, thread i adding its
  // columns 4 i + 512 k (k rising) one at a time, then a warp's tree and
  // the warps in order. The reference's rounding of a row's largest
  // normalized value (its s8 scale) turns on the last bit of the norm.
  __syncthreads();  // the row's values are in rowbuf
  float ss = 0.f;
  if (tid < NTHR / 2) {
    for (int c = tid * 4; c < D; c += NTHR * 2) {
      const float4 q = *reinterpret_cast<const float4*>(rowbuf + c);
      ss += q.x * q.x;
      ss += q.y * q.y;
      ss += q.z * q.z;
      ss += q.w * q.w;
    }
  }
  const float r = rsqrtf(block_sum(ss, sm) / static_cast<float>(D) + a.eps);
  // a sweep: rnd(x r ln) of RC runs of 4 columns from c0, their loads together
  auto sweep = [&](int c0, float (&u)[RC][4]) {
    float4 x4[RC];
    uint2 l2[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int c = c0 + i * NTHR * 4;
      x4[i] = c < D ? *reinterpret_cast<const float4*>(rowbuf + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      l2[i] = c < D ? *reinterpret_cast<const uint2*>(lnw + c) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&l2[i]);
      const float2 l01 = __bfloat1622float2(h[0]), l23 = __bfloat1622float2(h[1]);
      u[i][0] = rnd(x4[i].x * r * l01.x), u[i][1] = rnd(x4[i].y * r * l01.y);
      u[i][2] = rnd(x4[i].z * r * l23.x), u[i][3] = rnd(x4[i].w * r * l23.y);
    }
  };
  float m = 0.f;
  for (int c0 = tid * 4; c0 < D; c0 += NTHR * 4 * RC) {
    float u[RC][4];
    sweep(c0, u);
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m = fmaxf(m, fabsf(u[i][j]));
  }
  const float sq = block_max(m, sm) / 127.f + 1e-20f;
  const float inv = 1.f / sq;
  for (int c0 = tid * 4; c0 < D; c0 += NTHR * 4 * RC) {
    float u[RC][4];
    sweep(c0, u);
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int c = c0 + i * NTHR * 4;
      if (c < D)
        *reinterpret_cast<int*>(a.xq + row + c) = quant4(u[i][0], u[i][1], u[i][2], u[i][3], inv);
    }
  }
  if (tid == 0) a.xs[t] = sq;
}

__global__ void __launch_bounds__(NTHR, OCC)
    layer_fused_kernel(const __grid_constant__ CUtensorMap m_o,
                       const __grid_constant__ CUtensorMap m_gu,
                       const __grid_constant__ CUtensorMap m_dn,
                       const __grid_constant__ CUtensorMap m_qkv, const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  int8_t* xb = reinterpret_cast<int8_t*>(ring + RING);
  float* rowbuf = reinterpret_cast<float*>(xb);  // a row phase's values (xb is free then)
  __shared__ __align__(8) uint64_t full[NS];
  __shared__ __align__(16) uint32_t zero16[4];
  __shared__ Small sm;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const int cta = blockIdx.x, n_cta = gridDim.x;
  const int gtid = cta * NTHR + tid, gstride = n_cta * NTHR;
  const int T = a.T;
  const int col = warp * 16 + 2 * (lane >> 2);  // this lane's byte columns col, col + 1 of a box

  // This CTA's units of product p: its items cta, cta + n_cta, ...
  auto n_item_of = [&](int p) { return (items_of(a.w[p]) - cta + n_cta - 1) / n_cta; };
  auto units_of = [&](int p) {
    int n = 0;
    for (int m = 0; m < n_item_of(p); ++m) n += ng_of(a.w[p], cta + m * n_cta);
    return n;
  };

  stamp(0);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  if (tid < 4) zero16[tid] = 0u;
  if (cta == 0 && tid < T) a.hmax[tid] = 0;
  __syncthreads();

  // Thread 0's stream of the CTA's units over the four products: unit lk
  // is group lgi of item lj of product lp.
  int lk = 0, lp = 0, lj = cta, lgi = 0;
  auto settle = [&]() {
    while (lp < NPROD && lj >= items_of(a.w[lp])) {
      ++lp;
      lj = cta;
    }
  };
  auto load_next = [&]() {
    const Lin& w = a.w[lp];
    const int ncb = ncb_of(w), cb = lj % ncb, g = (lj / ncb) * gps_of(w) + lgi;
    uint8_t* stg = ring + (lk % NS) * STG;
    uint64_t* bar = &full[lk % NS];
    const int ncol = min(CB, w.half - cb * CB);
    const CUtensorMap* map = lp == 0 ? &m_o : lp == 1 ? &m_gu : lp == 2 ? &m_dn : &m_qkv;
    sm90::mbar_expect_tx(bar, WSTAGE + 4 * ncol * 2);
    sm90::tma_load_3d(stg, map, bar, cb * CB, g * GROUP, w.layer);
    k8::load_scales(stg, w.s2, w.z2, w.gp8 * w.half, g * w.half + cb * CB, ncol, bar);
    ++lk;
    if (++lgi == ng_of(w, lj)) {
      lgi = 0;
      lj += n_cta;
      settle();
    }
  };
  // Once every warp is done with the units before kdone, their stages are
  // free: thread 0 keeps up to NS units in flight, none past unit klimit.
  auto refill = [&](int kdone, int klimit) {
    if (tid == PRODUCER)
      while (lk < klimit && lk < kdone + NS) load_next();
  };
  if (tid == PRODUCER) settle();

  int k = 0, k_end = 0;  // the CTA's next unit to compute; the end of the product's units
  // Product p over the activations of kind SRC_* (rows of w.in: the bf16
  // attention rows or h quantized by sm.inv, or the s8 rows xq): each item
  // writes its partial part[(split T + t) OUT + column], which the phase
  // after the next barrier adds in split order.
  auto product = [&](int p, int kind, const void* src, int st_ready, int st_done) {
    const Lin& w = a.w[p];
    const int ncb = ncb_of(w), gps = gps_of(w), n_item = n_item_of(p), OUT = 2 * w.half;
    const int NG = n_item * gps, xrow = NG * GROUP + 16;
    int* xsum_s = reinterpret_cast<int*>(xb + T * xrow);
    // the groups of the CTA's items, item m's group gi in slot m gps + gi,
    // each token's 128 s8 values in the unit's order (8 threads a group,
    // 16 values each), and their sums
    const int units = T * NG * 8;
    for (int u0 = 0; u0 < units; u0 += NTHR) {
      const int u = u0 + tid, t = u / (NG * 8), sl = (u / 8) % NG, piece = u % 8;
      const int it = cta + (sl / gps) * n_cta, gi = sl % gps;
      const bool on = u < units && gi < ng_of(w, it);
      int sum = 0;
      if (on) {
        const size_t at = static_cast<size_t>(t) * w.in + ((it / ncb) * gps + gi) * GROUP + piece * 16;
        int n[16];
        if (kind == SRC_S8) {
          const uint4 v = __ldcg(reinterpret_cast<const uint4*>(static_cast<const int8_t*>(src) + at));
          const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            n[i] = static_cast<int>(static_cast<int8_t>((wd[i >> 2] >> (8 * (i & 3))) & 0xffu));
        } else if (kind == SRC_BF16) {
          const uint4* q = reinterpret_cast<const uint4*>(static_cast<const bf16*>(src) + at);
          const uint4 v[2] = {__ldg(q), __ldg(q + 1)};
          const bf16* e = reinterpret_cast<const bf16*>(v);
          const float inv = sm.inv[t];
#pragma unroll
          for (int i = 0; i < 16; ++i) n[i] = static_cast<int>(rintf(__bfloat162float(e[i]) * inv));
        } else {
          const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(src) + at);
          const float inv = sm.inv[t];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = __ldcg(q + i);
            n[4 * i] = static_cast<int>(rintf(v.x * inv));
            n[4 * i + 1] = static_cast<int>(rintf(v.y * inv));
            n[4 * i + 2] = static_cast<int>(rintf(v.z * inv));
            n[4 * i + 3] = static_cast<int>(rintf(v.w * inv));
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += n[i];
        *reinterpret_cast<uint4*>(xb + t * xrow + sl * GROUP + piece * 16) = k8::perm16(n);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (on && piece == 0) xsum_s[t * NG + sl] = sum;
    }
    __syncthreads();
    stamp(st_ready);
    refill(k, k_end);  // o-proj: its first units, asked for once its activations are read

    int c[2][1][4];
    float f[2][1][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[e][0][j] = 0;
        f[e][0][j] = 0.f;
      }
    int m = 0, gi = 0;  // the unit computed: the CTA's item m, its group gi
    for (; k < k_end; ++k) {
      sm90::mbar_wait(&full[k % NS], (k / NS) & 1);
      __syncthreads();  // unit k landed; every warp is done with unit k - 1
      refill(k, k_end);
      const uint8_t* stg = ring + (k % NS) * STG;
      const int it = cta + m * n_cta, slot = m * gps + gi;
      // B: token lane & 7 (a zero row past T), 16-byte block lane >> 3 of the pair
      k8::unit_mma<1>(stg, warp, lane, [&](int, int kp) -> const uint8_t* {
        const int t = lane & 7;
        return t < T ? reinterpret_cast<const uint8_t*>(xb) + t * xrow + slot * GROUP + kp * 64 +
                           (lane >> 3) * 16
                     : reinterpret_cast<const uint8_t*>(zero16);
      }, c);
      const int t0 = 2 * tig;
      unit_scale_folded(stg, col, t0 < T ? xsum_s[t0 * NG + slot] : 0,
                        t0 + 1 < T ? xsum_s[(t0 + 1) * NG + slot] : 0, c, f);
      if (++gi < ng_of(w, it)) continue;
      // The item's partial. Element j of f[e][0] is token 2 tig + (j & 1) of
      // output column (j >> 1) half + cb CB + col + e.
      const int cb = it % ncb, split = it / ncb;
      if (cb * CB + col < w.half) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 2 * tig + (j & 1);
          if (t < T)
            *reinterpret_cast<float2*>(a.part + (static_cast<size_t>(split) * T + t) * OUT +
                                       (j >> 1) * w.half + cb * CB + col) =
                make_float2(f[0][0][j], f[1][0][j]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) f[e][0][j] = 0.f;
      gi = 0;
      ++m;
    }
    __syncthreads();  // every warp is done with the product's units
    // the next product's first units, asked for before the barrier
    k_end += p + 1 < NPROD ? units_of(p + 1) : 0;
    refill(k, k_end);
    stamp(st_done);
  };

  // 1: o-proj; every CTA finds the attention rows' maxima itself (16-byte
  // loads, a sweep's issued together) before the first weights are asked for
  {
    constexpr int RC = 4;
    const int HD = a.w[0].in;
    for (int t = 0; t < T; ++t) {
      const bf16* row = a.attn + static_cast<size_t>(t) * HD;
      float m = 0.f;
      for (int c0 = tid * 8; c0 < HD; c0 += NTHR * 8 * RC) {
        uint4 u[RC];
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          const int c = c0 + i * NTHR * 8;
          u[i] = c < HD ? __ldg(reinterpret_cast<const uint4*>(row + c)) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
          }
        }
      }
      m = block_max(m, sm);
      if (tid == 0) {
        sm.s[t] = m / 127.f + 1e-20f;
        sm.inv[t] = 1.f / sm.s[t];
      }
    }
    __syncthreads();
  }
  k_end = units_of(0);
  product(0, SRC_BF16, a.attn, 1, 2);
  grid.sync();
  stamp(3);
  // 2: x1 and the gate/up activations
  if (cta < T) row_finish(a, cta, a.w[0].S, sm.s[cta], a.ln_mlp, false, rowbuf, sm);
  stamp(4);
  grid.sync();
  stamp(5);
  // 3: gate/up
  product(1, SRC_S8, a.xq, 6, 7);
  grid.sync();
  stamp(8);
  // 4: h = rnd(gate * sigmoid(gate) * up) and its row maxima
  const int I = a.w[1].half;
  for (int t = 0; t < T; ++t) {
    const float s = __ldcg(a.xs + t);
    const float* p = a.part + static_cast<size_t>(t) * 2 * I;
    const size_t n = static_cast<size_t>(T) * 2 * I;
    float m = 0.f;
    for (int j = gtid; j < I; j += gstride) {
      const float ag = split_sum(p + j, n, a.w[1].S), au = split_sum(p + I + j, n, a.w[1].S);
      float gate = rnd(ag * s), up = rnd(au * s);
      float h = rnd(gate * (1.f / (1.f + expf(-gate))) * up);
      a.hbuf[static_cast<size_t>(t) * I + j] = h;
      m = fmaxf(m, fabsf(h));
    }
    m = block_max(m, sm);
    if (tid == 0) atomicMax(a.hmax + t, __float_as_int(m));
  }
  stamp(9);
  grid.sync();
  stamp(10);
  // 5: down, h quantized by its row maxima
  if (tid < T) {
    sm.s[tid] = __int_as_float(__ldcg(a.hmax + tid)) / 127.f + 1e-20f;
    sm.inv[tid] = 1.f / sm.s[tid];
  }
  __syncthreads();
  product(2, SRC_F32, a.hbuf, 11, 12);
  grid.sync();
  stamp(13);
  // 6: x2 (the layer's output) and the next layer's qkv activations
  if (cta < T) row_finish(a, cta, a.w[2].S, sm.s[cta], a.ln_attn, true, rowbuf, sm);
  stamp(14);
  grid.sync();
  stamp(15);
  // 7: qkv
  product(3, SRC_S8, a.xq, 16, 17);
  grid.sync();
  stamp(18);
  // 8: the qkv rows
  const int Q = 2 * a.w[3].half;
  const size_t n = static_cast<size_t>(T) * Q;
  for (size_t i = gtid; i < n; i += gstride) {
    const float acc = split_sum(a.part + i, n, a.w[3].S);
    a.qkv_out[i] = __float2bfloat16_rn(acc * __ldcg(a.xs + i / Q));
  }
  stamp(19);
}

// The kernel's dynamic shared-memory limit, raised once a device (the first
// call, outside any CUDA-graph capture: kvz_w4a8_fused_grid).
cudaError_t smem_limit() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(layer_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

Lin lin(const void* s2, const void* z2, int layer, int in, int half, int gp8, int S) {
  return Lin{static_cast<const bf16*>(s2), static_cast<const bf16*>(z2), layer, in, half, gp8, S};
}

}  // namespace

#ifdef K12_STAMPS
extern "C" int kvz_w4a8_fused_stamps(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(k12_stamps, &buf, sizeof(buf)));
}
#endif

// The largest grid whose CTAs are all resident on the current device with
// the kernel's dynamic shared memory (SMEM bytes): occupancy (at most OCC
// an SM) times the SM count. Returns a CUDA error code; blocks gets 0 where
// none fits.
extern "C" int kvz_w4a8_fused_grid(int* blocks) {
  *blocks = 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = smem_limit();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_fused_kernel, NTHR, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  *blocks = (per_sm < OCC ? per_sm : OCC) * sms;
  return 0;
}

// The tensor map of a v2 weight stack q4 (L, IN, half) uint8: boxes of 128
// input rows x 128 byte columns of one layer, the 128-byte swizzle, the
// layer the third coordinate; written to out (128 bytes) for the wrapper to
// keep, so that a call encodes nothing.
extern "C" int kvz_w4a8_fused_map(const void* q4, int L, int IN, int half, void* out) {
  if (L < 1 || IN % GROUP || half % 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(half), static_cast<cuuint64_t>(IN),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t str[2] = {static_cast<cuuint64_t>(half),
                             static_cast<cuuint64_t>(IN) * static_cast<cuuint64_t>(half)};
  const cuuint32_t box[3] = {CB, GROUP, 1};
  if (!sm90::tensor_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_128B, q4, 3, dims,
                        str, box))
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(out, &map, sizeof(map));
  return 0;
}

// x (T, D) and attn (T, HD) bf16; ln_mlp / ln_attn (D,) bf16, this layer's
// and the next one's; map_* the stacks' tensor maps (kvz_w4a8_fused_map),
// of which layer `layer` is read (qkv_layer for qkv); for o, gate/up, down
// and qkv that layer's s2/z2 (2, Gp8, half) bf16 with their Gp8 and splits
// S; outputs x_new (T, D) and qkv (T, 2 half_qkv) bf16; scratch xq (T, D)
// int8, xs (T,) f32, hmax (T,) int32, xrow (T, D) f32, hbuf (T, I) f32 and
// part (max S * T * OUT) f32. grid: kvz_w4a8_fused_grid's blocks (the
// plan, ops/w4a8_fused.py::plan, keeps each CTA's quantized groups within
// XB_MAX).
extern "C" int kvz_w4a8_layer_fused(
    const void* x, const void* attn, const void* ln_mlp, const void* ln_attn,
    const void* map_o, const void* map_gu, const void* map_dn, const void* map_qkv,
    const void* o_s2, const void* o_z2, const void* gu_s2, const void* gu_z2,
    const void* dn_s2, const void* dn_z2, const void* qkv_s2, const void* qkv_z2,
    void* x_new, void* qkv_out, void* xq, void* xs, void* hmax, void* xrow, void* hbuf,
    void* part, int T, int D, int HD, int I, int half_qkv,
    int o_gp8, int gu_gp8, int dn_gp8, int qkv_gp8,
    int o_S, int gu_S, int dn_S, int qkv_S, int layer, int qkv_layer, int grid, float eps,
    void* stream) {
  if (T < 1 || T > MAX_T || grid < 1 || HD % GROUP || D % GROUP || I % GROUP ||
      D * 4 > XB_MAX ||  // a row phase holds the row in shared memory
      half_qkv % 16 || o_S < 1 || gu_S < 1 || dn_S < 1 || qkv_S < 1 ||
      o_S > MAX_SPLITS || gu_S > MAX_SPLITS || dn_S > MAX_SPLITS || qkv_S > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = smem_limit();
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.attn = static_cast<const bf16*>(attn);
  a.ln_mlp = static_cast<const bf16*>(ln_mlp);
  a.ln_attn = static_cast<const bf16*>(ln_attn);
  a.w[0] = lin(o_s2, o_z2, layer, HD, D / 2, o_gp8, o_S);
  a.w[1] = lin(gu_s2, gu_z2, layer, D, I, gu_gp8, gu_S);
  a.w[2] = lin(dn_s2, dn_z2, layer, I, D / 2, dn_gp8, dn_S);
  a.w[3] = lin(qkv_s2, qkv_z2, qkv_layer, D, half_qkv, qkv_gp8, qkv_S);
  a.x_new = static_cast<bf16*>(x_new);
  a.qkv_out = static_cast<bf16*>(qkv_out);
  a.xq = static_cast<int8_t*>(xq);
  a.xs = static_cast<float*>(xs);
  a.hmax = static_cast<int*>(hmax);
  a.xrow = static_cast<float*>(xrow);
  a.hbuf = static_cast<float*>(hbuf);
  a.part = static_cast<float*>(part);
  a.T = T;
  a.D = D;
  a.eps = eps;
  CUtensorMap maps[NPROD];
  memcpy(&maps[0], map_o, sizeof(CUtensorMap));
  memcpy(&maps[1], map_gu, sizeof(CUtensorMap));
  memcpy(&maps[2], map_dn, sizeof(CUtensorMap));
  memcpy(&maps[3], map_qkv, sizeof(CUtensorMap));
  void* params[] = {&maps[0], &maps[1], &maps[2], &maps[3], &a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layer_fused_kernel), dim3(grid),
                                  dim3(NTHR), params, SMEM, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
