// K4: decode attention (T <= 8 queries) against the dense cache with
// per-head live lengths.
//
// Replaces kvzip_tpu/ops/ragged_decode.py::ragged_decode_attend
// (_decode_kernel). Head h's live keys are rows [0, base_lens[h] + T): the
// T new rows were appended at base_lens[h] and are causal among themselves
// (key j visible to query i iff j < base_lens[h] + i + 1).
//
// Bound on the H100: device-memory bytes (each live K/V row is read once).
// Design: the TPU kernel carried (m, l, acc) in scratch across a sequential
// key axis; one CTA per head would leave most of the 132 SMs idle. This is
// flash-decoding instead: each head's live rows are cut into splits of CH
// keys, one CTA per (split, kv head, group of 64 packed rows), and each CTA
// writes its partial (m, l, acc); a second small kernel merges the splits.
// The GQA group and the T queries pack into R = G * T rows (row r = query
// r % T of head r / T), padded to 16-row mma tiles and masked. Splits past a
// head's live length load nothing.
#include "attn_common.cuh"

using namespace kvz;

__global__ void ragged_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const int* __restrict__ base_lens, float* part_acc,
                                      float* part_ml, int T, int H, int C, int G, int CH, int S,
                                      float scale) {
  __shared__ __align__(16) bf16 Ks[BK * SROW];
  __shared__ __align__(16) bf16 Vs[BK * SROW];
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

  Online st;
  st.init();
  const int base = base_lens[hk];
  const int k0 = split * CH, k1 = min(min(k0 + CH, base + T), C);
  const bf16* kh = k + static_cast<size_t>(hk) * C * D;
  const bf16* vh = v + static_cast<size_t>(hk) * C * D;
  for (int c0 = k0; c0 < k1; c0 += BK) {
    __syncthreads();
    int n = min(BK, k1 - c0);
    load_tile(Ks, kh, c0, n, tid, nthr);
    load_tile(Vs, vh, c0, n, tid, nthr);
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    float s[NT_K][4];
    qk_tile(s, qa, Ks, gid, tig);
#pragma unroll
    for (int nt = 0; nt < NT_K; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int col = c0 + nt * 8 + tig * 2 + (j & 1);
        int qi = (j >> 1) ? qi_hi : qi_lo;
        bool ok = col < base + qi + 1 && col < k1;
        s[nt][j] = ok ? s[nt][j] * scale : -INFINITY;
      }
    }
    st.update(s, Vs, gid, tig);
  }
  if (active) write_partial(st, part_acc, part_ml, hk, split, S, R, r_lo, gid, tig, k0 < k1);
}

// q (T, H, D), k/v (Hkv, C, D) bf16; base_lens (Hkv,) int32; out (T, H, D);
// part_acc (Hkv, S, G*T, D) and part_ml (Hkv, S, G*T, 2) f32 scratch, S = ceil(C / CH).
extern "C" int kvz_ragged_decode(const void* q, const void* k, const void* v,
                                 const void* base_lens, void* out, void* part_acc,
                                 void* part_ml, int T, int H, int Hkv, int C, int CH,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G = H / Hkv, R = G * T, S = (C + CH - 1) / CH;
  dim3 grid(S, Hkv, (R + 63) / 64);
  ragged_partial_kernel<<<grid, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(base_lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), T, H, C, G, CH, S, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_partials_kernel<<<dim3(R, Hkv), D, 0, st>>>(static_cast<const float*>(part_acc),
                                                    static_cast<const float*>(part_ml),
                                                    static_cast<bf16*>(out), T, H, G, S, R);
  return static_cast<int>(cudaGetLastError());
}
