// Hopper (sm_90a) building blocks of the redesigned kernels (K1-K12,
// K14-K16): mbarriers, TMA tensor and bulk loads, cluster barriers and
// distributed shared memory, wgmma descriptors and issue, ldmatrix, s8 mma
// and a cp.async ring, and the host-side tensor-map encoder (reached
// through cudaGetDriverEntryPoint, so no library beyond the CUDA runtime is
// linked).
//
// wgmma fragments (PTX ISA, "wgmma .m64nNk16"): warp w of the warpgroup
// holds rows 16w..16w+15 of the 64-row tile; lane l holds rows l/4 and
// l/4 + 8, columns 8j + 2(l%4) and +1 of each 8-column tile j, as
// mma.sync m16n8 does. A register-sourced A operand uses mma.sync's
// m16n8k16 A layout for the warp's 16 rows.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed. A
// phase that never completes (a lost arrival or byte count) traps after
// about 4 s of the global timer instead of hanging the card (each try of
// try_wait may suspend the thread for a while, so a count of tries is no
// clock).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t addr = smem_u32(bar), done = 0;
  uint64_t t0 = 0;
  for (uint32_t tries = 1; !done; ++tries) {
    if ((tries & 0xFFFF) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (!t0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------- flags in global memory
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One thread's acquire after relaxed polls; a CTA barrier after it orders
// the other threads' reads too.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ void red_add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// A relaxed atomic add whose result the thread waits for only where it is
// used (atomicAdd from one lane is rewritten into a warp-aggregated atomic
// whose result the whole warp waits for at once).
__device__ __forceinline__ unsigned atom_add(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.relaxed.gpu.global.add.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v));
  return old;
}

// Orders earlier generic-proxy accesses (and what they observed) before
// later async-proxy (TMA) accesses of global memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Orders this thread's earlier generic-proxy writes of shared memory before
// later async-proxy (wgmma, TMA) accesses of it; the writer fences, then
// arrives on the barrier the reader waits for.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `threads` threads (whole warps) of the CTA; id 0 is
// __syncthreads'.
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- clusters
// barrier.cluster: every thread of every CTA of the cluster arrives (so
// every thread calls these, in warp-uniform control flow); the wait
// returns once all have arrived. arrive releases the thread's earlier
// accesses, wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v into the float at p in the shared memory of the cluster's CTA `rank`,
// counted (4 bytes) on that CTA's mbarrier at the same address as `bar`.
__device__ __forceinline__ void st_async_cluster(float* p, float v, uint64_t* bar,
                                                 uint32_t rank) {
  uint32_t rp, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rp) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(rp),
               "r"(__float_as_uint(v)), "r"(rb)
               : "memory");
}

// --------------------------------------------------------------------- TMA
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, counted on the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a tile written by TMA with the
// 128-byte swizzle (rows of 128 bytes, 8-row atoms of 1,024 bytes, the
// atom 1,024-byte aligned). `lbo` and `sbo` are byte offsets: for a
// K-major operand sbo is the stride between 8-row groups and lbo is unused;
// for an MN-major one lbo is the stride between 64-element column blocks
// and sbo the stride between 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_ACC64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_ACC64_OUT \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A . B^T: A (64 x 16) and B (128 x 16) K-major in shared memory;
// accumulate when `accumulate` is non-zero, else overwrite.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_ACC64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC64_OUT
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B: A (64 x 16) bf16 in registers, B (16 x 128) MN-major in
// shared memory (the transposed-B form).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_ACC64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_ACC64_OUT
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_ACC64
#undef SM90_ACC64_OUT

// Register budget of a warp-specialized kernel: the producer warpgroup gives
// registers up, the consumers take them. The consumers can take only what
// the CTA's own warps gave up from its launch allocation (168 a thread at
// 384 threads: 64,512), so producer * 128 + consumers * 256 must stay within
// it; asking for more blocks setmaxnreg.inc for ever.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------ ldmatrix, cp.async
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a . b, m16n8k32 with s8 operands and s32 sums (exact).
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x / d from the correctly rounded reciprocal r = 1 / d and one
// correction step of the product (Markstein): the IEEE quotient for the
// normal operands here, at a fraction of the division routine's cost.
__device__ __forceinline__ float div_rn(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map with zero fill out of bounds. dims[0] is the contiguous
// dimension; strides are in bytes, for dims 1..n-1.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
                       const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 rows with the 128-byte swizzle (the layout desc_sw128 describes).
inline bool bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, ptr, rank,
                    dims, strides, box);
}

// uint8 rows (packed int4) as they lie, without a swizzle.
inline bool u8_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE, ptr, rank, dims,
                    strides, box);
}

}  // namespace sm90
