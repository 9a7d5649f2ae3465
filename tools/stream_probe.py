#!/usr/bin/env python3
"""Device-memory read rate of the access patterns a decode-shape W4A8
linear can use, on qwen2.5-7b's gate/up bytes (3,584 rows x 18,944 bytes)
and its int4 lm_head's (3,584 x 76,032): one CTA an SM (132), each reading
column strips of W bytes (W = 128, 256, 512, 1024) from top to bottom, strip
c, c + 132, ... (the order a stream-K grid of column blocks gives), or the
whole matrix row-major in 132 equal runs (contiguous bytes). Loads are
16 bytes a thread, eight in flight. Prints one JSON line a pattern: ms and
TB/s (CUDA events over 20 calls). Needs a card and nvcc.

    python3 tools/stream_probe.py
"""

import ctypes
import json
import os
import subprocess

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// CTA c reads strips c, c + gridDim.x, ... of W bytes x R rows (row stride C)
template <int W>
__global__ void __launch_bounds__(256) strips(const uint4* __restrict__ m, int R, int C,
                                              uint32_t* out) {
  constexpr int TPR = W / 16;            // threads a row
  constexpr int RPI = 256 / TPR;         // rows an iteration
  const int n_strips = C / W, lane = threadIdx.x % TPR, r0 = threadIdx.x / TPR;
  uint32_t acc = 0;
  for (int s = blockIdx.x; s < n_strips; s += gridDim.x) {
    const uint4* base = m + (static_cast<size_t>(s) * W) / 16 + lane;
    for (int r = r0; r < R; r += 8 * RPI) {
      uint4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rr = r + i * RPI;
        v[i] = rr < R ? __ldg(base + static_cast<size_t>(rr) * (C / 16)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc ^= v[i].x ^ v[i].y ^ v[i].z ^ v[i].w;
    }
  }
  if (acc == 0x12345678u) out[blockIdx.x] = acc;
}
// CTA c reads bytes [c n / grid, (c + 1) n / grid) of the matrix in order
__global__ void __launch_bounds__(256) rows(const uint4* __restrict__ m, size_t n16,
                                            uint32_t* out) {
  const size_t per = (n16 + gridDim.x - 1) / gridDim.x, b = blockIdx.x * per,
               e = min(n16, b + per);
  uint32_t acc = 0;
  for (size_t i = b + threadIdx.x; i < e; i += 8 * 256) {
    uint4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = i + k * 256 < e ? __ldg(m + i + k * 256) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
  }
  if (acc == 0x12345678u) out[blockIdx.x] = acc;
}
extern "C" int run(int kind, const void* m, int R, int C, void* out, int grid, void* st) {
  cudaStream_t s = static_cast<cudaStream_t>(st);
  const uint4* p = static_cast<const uint4*>(m);
  uint32_t* o = static_cast<uint32_t*>(out);
  switch (kind) {
    case 128: strips<128><<<grid, 256, 0, s>>>(p, R, C, o); break;
    case 256: strips<256><<<grid, 256, 0, s>>>(p, R, C, o); break;
    case 512: strips<512><<<grid, 256, 0, s>>>(p, R, C, o); break;
    case 1024: strips<1024><<<grid, 256, 0, s>>>(p, R, C, o); break;
    default: rows<<<grid, 256, 0, s>>>(p, static_cast<size_t>(R) * C / 16, o);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def main():
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card)), flush=True)
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "kvzip_tpu_torch", "build")  # gitignored
    os.makedirs(build, exist_ok=True)
    src, lib = os.path.join(build, "stream_probe.cu"), os.path.join(build, "libstream_probe.so")
    with open(src, "w") as f:
        f.write(SRC)
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(1024, dtype=torch.int32, device="cuda")
    grid = torch.cuda.get_device_properties(0).multi_processor_count
    for name, R, C in (("gate/up", 3584, 18944), ("lm_head", 3584, 76032)):
        mats = [torch.randint(0, 255, (R, C), dtype=torch.uint8, device="cuda") for _ in range(4)]
        for kind in (128, 256, 512, 1024, 0):
            st = torch.cuda.current_stream().cuda_stream

            def call(i):
                assert fn(kind, mats[i % 4].data_ptr(), R, C, out.data_ptr(), grid, st) == 0

            for i in range(3):
                call(i)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(20):
                call(i)
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b) / 20
            print(json.dumps(dict(matrix=name, pattern=f"strips {kind} B" if kind else "rows",
                                  ms=ms, tb_s=R * C / ms / 1e9)), flush=True)
        del mats


if __name__ == "__main__":
    main()
