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
// Weights: the v2 storage of K8 (csrc/w4a8.cu): bytes (IN, OUT/2) per
// layer, output column j in the high nibble and j + OUT/2 in the low one,
// stored XOR 0x80; bf16 s2/z2 (2, Gp8, OUT/2) with the high half pre-folded
// as s_hi / 16 and z_hi + 8 s_hi. The reference's algebra uses them as they
// are: with b the stored byte read as s8 and lo its low nibble, per group
// of 128 input rows acc_hi += (x.b - x.lo) * sh + sum(x) * zh and
// acc_lo += x.lo * sl + sum(x) * zl, the dot products exact in int32 (dp4a).
//
// Bound on the H100: device-memory bytes (the four weight slices and their
// scales, ~125 MB a layer at qwen2.5-7b, 0.037 ms at 3.35 TB/s).
// Design: the TPU ran one sequential grid and kept the residual row, the s8
// activations and the hidden row in VMEM. Here one persistent cooperative
// launch, every CTA resident (the grid is the occupancy times the SM
// count), walks seven phases separated by grid-wide barriers:
//   1 o-proj (every CTA quantizes the attention rows on the fly from their
//     maxima, which it computes itself)    2 x1, norm, quant (CTA t: row t)
//   3 gate/up    4 SiLU*up into h and its row maxima (all CTAs, atomicMax)
//   5 down (h quantized on the fly)        6 x2, norm, quant (CTA t: row t)
//   7 qkv        8 the qkv rows (all CTAs).
// A product phase cuts the byte columns into items of 128 columns times a
// split of the input groups; the four warps of a CTA take alternate groups
// of an item (a lane: 4 byte columns, 8 output columns), sum in a fixed
// order through shared memory, and write one float partial per split. The
// consumer sums the splits in order, so results do not depend on timing.
// Partials stay small (the splits are capped so that they are at most 1/8
// of the weight bytes) and in L2. Scratch written in one phase and read in
// a later one is read with ld.global.cg (L2), never through L1.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;
constexpr int GROUP = 128;
constexpr int NTHR = 128;
constexpr int NWARP = NTHR / 32;
constexpr int CB = 128;        // byte columns of a work item (32 lanes x 4)
// row quads a lane loads ahead of their use: more bytes in flight where
// the accumulators leave registers for them
__host__ __device__ constexpr int pf_for(int tt) { return tt == 1 ? 16 : 8; }
constexpr int MAX_T = 8;
constexpr int MAX_CTAS_PER_SM = 4;
constexpr int MAX_SPLITS = 16;  // splits of a product's input groups

enum Src { SRC_S8 = 0, SRC_BF16 = 1, SRC_F32 = 2 };

struct Lin {  // one layer's slice of a v2 weight stack
  const uint8_t* q4;  // (in, half)
  const bf16* s2;     // (2, gp8, half)
  const bf16* z2;
  int in, half, gp8, S;  // S: splits of the input groups
};

struct Args {
  const bf16* x;        // (T, D)
  const bf16* attn;     // (T, o.in)
  const bf16* ln_mlp;   // (D,) this layer's
  const bf16* ln_attn;  // (D,) the next layer's
  Lin o, gu, dn, qkv;
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

struct Smem {
  int xw[NWARP][MAX_T][GROUP / 4];   // each warp's group of s8 activations
  int xsum[NWARP][MAX_T];
  float red[MAX_T][2 * CB];          // warp-to-warp sums of an item
  float s[MAX_T], inv[MAX_T];        // activation scales of this phase
  float r[NWARP];                    // block reductions
};

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) r += red[w];
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ int quant4(float a, float b, float c, float d, float inv) {
  uint32_t w = (static_cast<uint32_t>(static_cast<int>(rintf(a * inv)) & 0xff)) |
               (static_cast<uint32_t>(static_cast<int>(rintf(b * inv)) & 0xff) << 8) |
               (static_cast<uint32_t>(static_cast<int>(rintf(c * inv)) & 0xff) << 16) |
               (static_cast<uint32_t>(static_cast<int>(rintf(d * inv)) & 0xff) << 24);
  return static_cast<int>(w);
}

// Four s8 activations of token row t at column col, from the phase's source.
__device__ __forceinline__ int load_act(int kind, const void* src, int ld, int t, int col,
                                        float inv) {
  const size_t i = static_cast<size_t>(t) * ld + col;
  if (kind == SRC_S8) return __ldcg(reinterpret_cast<const int*>(static_cast<const int8_t*>(src) + i));
  if (kind == SRC_BF16) {
    uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const bf16*>(src) + i));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    return quant4(a.x, a.y, b.x, b.y, inv);
  }
  float4 f = __ldcg(reinterpret_cast<const float4*>(static_cast<const float*>(src) + i));
  return quant4(f.x, f.y, f.z, f.w, inv);
}

// One product: partial sums part[(split * T + t) * 2 half + column] (before
// the token scale) of every item.
template <int TT>
__device__ void product(const Lin& w, int kind, const void* src, int T, float* part, Smem& sm) {
  const int ncb = (w.half + CB - 1) / CB;
  const int G = w.in / GROUP;
  const int gps = (G + w.S - 1) / w.S;
  const int items = ncb * w.S;
  const int OUT = 2 * w.half;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int PF = pf_for(TT);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int cb = it % ncb, ks = it / ncb;
    const int j0 = cb * CB + lane * 4;
    const bool col_ok = j0 < w.half;
    const int g1 = min((ks + 1) * gps, G);
    float f_hi[TT][4], f_lo[TT][4];
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) f_hi[t][c] = f_lo[t][c] = 0.f;

    for (int g = ks * gps + warp; g < g1; g += NWARP) {
      __syncwarp();
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        int v = t < T ? load_act(kind, src, w.in, t, g * GROUP + lane * 4, sm.inv[t]) : 0;
        sm.xw[warp][t][lane] = v;
        int sum = __dp4a(v, 0x01010101, 0);
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) sm.xsum[warp][t] = sum;
      }
      __syncwarp();
      if (!col_ok) continue;
      int a_b[TT][4], a_l[TT][4];
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) a_b[t][c] = a_l[t][c] = 0;
      const uint8_t* wg = w.q4 + static_cast<size_t>(g) * GROUP * w.half + j0;
      for (int k0 = 0; k0 < GROUP / 4; k0 += PF) {
        uint32_t r[PF][4];
#pragma unroll
        for (int i = 0; i < PF; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            r[i][j] = __ldg(reinterpret_cast<const uint32_t*>(
                wg + static_cast<size_t>(4 * (k0 + i) + j) * w.half));
#pragma unroll
        for (int i = 0; i < PF; ++i) {
          // byte-transpose: word c holds column j0 + c of the quad's 4 rows
          uint32_t a = __byte_perm(r[i][0], r[i][1], 0x5140);
          uint32_t b = __byte_perm(r[i][2], r[i][3], 0x5140);
          uint32_t e = __byte_perm(r[i][0], r[i][1], 0x7362);
          uint32_t f = __byte_perm(r[i][2], r[i][3], 0x7362);
          uint32_t col[4] = {__byte_perm(a, b, 0x5410), __byte_perm(a, b, 0x7632),
                             __byte_perm(e, f, 0x5410), __byte_perm(e, f, 0x7632)};
          int xv[TT];
#pragma unroll
          for (int t = 0; t < TT; ++t) xv[t] = sm.xw[warp][t][k0 + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int sb = static_cast<int>(col[c]);              // stored bytes as s8
            int lo = static_cast<int>(col[c] & 0x0F0F0F0Fu);  // their low nibbles
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              a_b[t][c] = __dp4a(xv[t], sb, a_b[t][c]);
              a_l[t][c] = __dp4a(xv[t], lo, a_l[t][c]);
            }
          }
        }
      }
      const size_t o_hi = static_cast<size_t>(g) * w.half + j0;
      const size_t o_lo = (static_cast<size_t>(w.gp8) + g) * w.half + j0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sh = __bfloat162float(w.s2[o_hi + c]), zh = __bfloat162float(w.z2[o_hi + c]);
        float sl = __bfloat162float(w.s2[o_lo + c]), zl = __bfloat162float(w.z2[o_lo + c]);
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          float xsm = static_cast<float>(sm.xsum[warp][t]);
          f_hi[t][c] += static_cast<float>(a_b[t][c] - a_l[t][c]) * sh + xsm * zh;
          f_lo[t][c] += static_cast<float>(a_l[t][c]) * sl + xsm * zl;
        }
      }
    }
    // the warps' sums in a fixed order; the last warp writes the partial
#pragma unroll
    for (int wv = 0; wv < NWARP; ++wv) {
      __syncthreads();
      if (warp != wv) continue;
#pragma unroll
      for (int t = 0; t < TT; ++t) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float h = f_hi[t][c], l = f_lo[t][c];
          if (wv > 0) {
            h += sm.red[t][lane * 4 + c];
            l += sm.red[t][CB + lane * 4 + c];
          }
          f_hi[t][c] = h;
          f_lo[t][c] = l;
          if (wv < NWARP - 1) {
            sm.red[t][lane * 4 + c] = h;
            sm.red[t][CB + lane * 4 + c] = l;
          }
        }
        if (wv == NWARP - 1 && col_ok && t < T) {
          float* p = part + (static_cast<size_t>(ks) * T + t) * OUT;
          *reinterpret_cast<float4*>(p + j0) =
              make_float4(f_hi[t][0], f_hi[t][1], f_hi[t][2], f_hi[t][3]);
          *reinterpret_cast<float4*>(p + w.half + j0) =
              make_float4(f_lo[t][0], f_lo[t][1], f_lo[t][2], f_lo[t][3]);
        }
      }
    }
  }
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

__device__ __forceinline__ void split_sum4(const float* p, size_t n, int S, float acc[4]) {
  float4 v[MAX_SPLITS];
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k)
    v[k] = k < S ? __ldcg(reinterpret_cast<const float4*>(p + k * n)) : make_float4(0.f, 0.f, 0.f, 0.f);
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_SPLITS; ++k) {
    acc[0] += v[k].x;
    acc[1] += v[k].y;
    acc[2] += v[k].z;
    acc[3] += v[k].w;
  }
}

__device__ __forceinline__ void load4(const bf16* p, float f[4]) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

// Row t of a D-wide product (o-proj or down) added to the residual:
// v = rnd(base + rnd(sum of splits * s)), base the input row x (o-proj) or
// x1 (down, which also writes the layer's output); then RMSNorm with lnw
// and the s8 quantization into xq / xs. Four columns a thread at a time.
__device__ void row_finish(const Args& a, int t, const Lin& w, float s, const bf16* lnw,
                           bool down, Smem& sm) {
  const int D = a.D, tid = threadIdx.x;
  const size_t n = static_cast<size_t>(a.T) * D, row = static_cast<size_t>(t) * D;
  float* xr = a.xrow + row;
  float ss = 0.f;
  for (int c = tid * 4; c < D; c += NTHR * 4) {
    float acc[4], base[4], v[4];
    split_sum4(a.part + row + c, n, w.S, acc);
    if (down) {
      float4 b = *reinterpret_cast<const float4*>(xr + c);
      base[0] = b.x, base[1] = b.y, base[2] = b.z, base[3] = b.w;
    } else {
      load4(a.x + row + c, base);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = rnd(base[j] + rnd(acc[j] * s));
      ss += v[j] * v[j];
    }
    *reinterpret_cast<float4*>(xr + c) = make_float4(v[0], v[1], v[2], v[3]);
    if (down) {
      __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(a.x_new + row + c) = *reinterpret_cast<const uint2*>(h);
    }
  }
  const float r = rsqrtf(block_sum(ss, sm.r) / static_cast<float>(D) + a.eps);
  float m = 0.f;
  for (int c = tid * 4; c < D; c += NTHR * 4) {
    float4 x4 = *reinterpret_cast<const float4*>(xr + c);
    float l[4];
    load4(lnw + c, l);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(rnd(x4.x * r * l[0])), fabsf(rnd(x4.y * r * l[1]))),
                       fmaxf(fabsf(rnd(x4.z * r * l[2])), fabsf(rnd(x4.w * r * l[3])))));
  }
  const float sq = block_max(m, sm.r) / 127.f + 1e-20f;
  const float inv = 1.f / sq;
  for (int c = tid * 4; c < D; c += NTHR * 4) {
    float4 x4 = *reinterpret_cast<const float4*>(xr + c);
    float l[4];
    load4(lnw + c, l);
    *reinterpret_cast<int*>(a.xq + row + c) =
        quant4(rnd(x4.x * r * l[0]), rnd(x4.y * r * l[1]), rnd(x4.z * r * l[2]),
               rnd(x4.w * r * l[3]), inv);
  }
  if (tid == 0) a.xs[t] = sq;
}

template <int TT>
__global__ void __launch_bounds__(NTHR) layer_fused_kernel(Args a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * NTHR + tid, gstride = gridDim.x * NTHR;
  const int T = a.T;

  // 1: o-proj; every CTA finds the attention rows' maxima itself
  if (blockIdx.x == 0 && tid < T) a.hmax[tid] = 0;
  for (int t = 0; t < T; ++t) {
    const bf16* row = a.attn + static_cast<size_t>(t) * a.o.in;
    float m = 0.f;
    for (int c = tid * 4; c < a.o.in; c += NTHR * 4) {
      float f[4];
      load4(row + c, f);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3]))));
    }
    m = block_max(m, sm.r);
    if (tid == 0) {
      sm.s[t] = m / 127.f + 1e-20f;
      sm.inv[t] = 1.f / sm.s[t];
    }
  }
  __syncthreads();
  product<TT>(a.o, SRC_BF16, a.attn, T, a.part, sm);
  grid.sync();
  // 2: x1 and the gate/up activations
  if (blockIdx.x < T) row_finish(a, blockIdx.x, a.o, sm.s[blockIdx.x], a.ln_mlp, false, sm);
  grid.sync();
  // 3: gate/up
  product<TT>(a.gu, SRC_S8, a.xq, T, a.part, sm);
  grid.sync();
  // 4: h = rnd(gate * sigmoid(gate) * up) and its row maxima
  const int I = a.gu.half;
  for (int t = 0; t < T; ++t) {
    const float s = __ldcg(a.xs + t);
    const float* p = a.part + static_cast<size_t>(t) * 2 * I;
    const size_t n = static_cast<size_t>(T) * 2 * I;
    float m = 0.f;
    for (int j = gtid; j < I; j += gstride) {
      const float ag = split_sum(p + j, n, a.gu.S), au = split_sum(p + I + j, n, a.gu.S);
      float gate = rnd(ag * s), up = rnd(au * s);
      float h = rnd(gate * (1.f / (1.f + expf(-gate))) * up);
      a.hbuf[static_cast<size_t>(t) * I + j] = h;
      m = fmaxf(m, fabsf(h));
    }
    m = block_max(m, sm.r);
    if (tid == 0) atomicMax(a.hmax + t, __float_as_int(m));
  }
  grid.sync();
  // 5: down, h quantized on the fly by its row maxima
  if (tid < T) {
    sm.s[tid] = __int_as_float(__ldcg(a.hmax + tid)) / 127.f + 1e-20f;
    sm.inv[tid] = 1.f / sm.s[tid];
  }
  __syncthreads();
  product<TT>(a.dn, SRC_F32, a.hbuf, T, a.part, sm);
  grid.sync();
  // 6: x2 (the layer's output) and the next layer's qkv activations
  if (blockIdx.x < T) row_finish(a, blockIdx.x, a.dn, sm.s[blockIdx.x], a.ln_attn, true, sm);
  grid.sync();
  // 7: qkv
  product<TT>(a.qkv, SRC_S8, a.xq, T, a.part, sm);
  grid.sync();
  // 8: the qkv rows
  const int Q = 2 * a.qkv.half;
  const size_t n = static_cast<size_t>(T) * Q;
  for (size_t i = gtid; i < n; i += gstride) {
    const float acc = split_sum(a.part + i, n, a.qkv.S);
    a.qkv_out[i] = __float2bfloat16_rn(acc * __ldcg(a.xs + i / Q));
  }
}

void* kernel_for(int tt) {
  if (tt == 1) return reinterpret_cast<void*>(layer_fused_kernel<1>);
  if (tt == 4) return reinterpret_cast<void*>(layer_fused_kernel<4>);
  if (tt == 8) return reinterpret_cast<void*>(layer_fused_kernel<8>);
  return nullptr;
}

Lin lin(const void* q4, const void* s2, const void* z2, int in, int half, int gp8, int S) {
  return Lin{static_cast<const uint8_t*>(q4), static_cast<const bf16*>(s2),
             static_cast<const bf16*>(z2), in, half, gp8, S};
}

}  // namespace

// The largest grid of the tt-token kernel (1, 4 or 8) whose CTAs are all
// resident on the current device: occupancy (at most 4 a SM) times the SM
// count. Returns a CUDA error code; blocks gets 0 where none fits.
extern "C" int kvz_w4a8_fused_grid(int tt, int* blocks) {
  *blocks = 0;
  void* k = kernel_for(tt);
  if (!k) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, NTHR, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  *blocks = (per_sm < MAX_CTAS_PER_SM ? per_sm : MAX_CTAS_PER_SM) * sms;
  return 0;
}

// x (T, D) and attn (T, HD) bf16; ln_mlp / ln_attn (D,) bf16, this layer's
// and the next one's; for o, gate/up, down and qkv one layer's v2 slices
// q4 (IN, half) uint8 and s2/z2 (2, Gp8, half) bf16 with their IN, half,
// Gp8 and splits S; outputs x_new (T, D) and qkv (T, 2 half_qkv) bf16;
// scratch xq (T, D) int8, xs (T,) f32, hmax (T,) int32, xrow (T, D) f32,
// hbuf (T, half_gu) f32 and part (max S * T * OUT) f32. grid: at most
// kvz_w4a8_fused_grid's blocks for tt (1, 4 or 8, >= T).
extern "C" int kvz_w4a8_layer_fused(
    const void* x, const void* attn, const void* ln_mlp, const void* ln_attn,
    const void* o_q4, const void* o_s2, const void* o_z2,
    const void* gu_q4, const void* gu_s2, const void* gu_z2,
    const void* dn_q4, const void* dn_s2, const void* dn_z2,
    const void* qkv_q4, const void* qkv_s2, const void* qkv_z2,
    void* x_new, void* qkv_out, void* xq, void* xs, void* hmax, void* xrow, void* hbuf,
    void* part, int T, int D, int HD, int I, int half_qkv,
    int o_gp8, int gu_gp8, int dn_gp8, int qkv_gp8,
    int o_S, int gu_S, int dn_S, int qkv_S, int tt, int grid, float eps, void* stream) {
  void* k = kernel_for(tt);
  if (!k || T < 1 || T > tt || T > MAX_T || grid < 1 || D % 4 || HD % 4 ||
      o_S > MAX_SPLITS || gu_S > MAX_SPLITS || dn_S > MAX_SPLITS || qkv_S > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.attn = static_cast<const bf16*>(attn);
  a.ln_mlp = static_cast<const bf16*>(ln_mlp);
  a.ln_attn = static_cast<const bf16*>(ln_attn);
  a.o = lin(o_q4, o_s2, o_z2, HD, D / 2, o_gp8, o_S);
  a.gu = lin(gu_q4, gu_s2, gu_z2, D, I, gu_gp8, gu_S);
  a.dn = lin(dn_q4, dn_s2, dn_z2, I, D / 2, dn_gp8, dn_S);
  a.qkv = lin(qkv_q4, qkv_s2, qkv_z2, D, half_qkv, qkv_gp8, qkv_S);
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
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(NTHR), params, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
