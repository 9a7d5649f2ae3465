#!/usr/bin/env python3
"""Where K13's time goes: ``csrc/fused_act.cu`` rebuilt with one change at a
time and its ``rmsnorm_quant`` entry timed at llama3.1-8b's D 4,096 and T
1, 256, 2,304 and 4,096 (``graph_ms`` of 56 calls), at the grid
``ops/fused_act.py::plan_norm`` gives for each K (the first form's threads
a thread stands for: 1, 2, 4) and at one row a CTA.

    python3 tools/k13_variants.py [--out FILE] [--only as_is,no_pdl,...]

Each variant is the source with a text substitution (``VARIANTS``), built
with the port's nvcc flags into a temporary directory (all at once) and
called through its C entry. Each line gives the variant, its plan
(grid, threads, K, rows in flight a CTA), the kernel's resident CTAs an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its time, and whether
its output's bytes are the unchanged source's (variants that drop work
differ). Beside them, per T, the same bytes moved by one PyTorch call
(``x.to(torch.int8)``: bf16 rows read, int8 rows written), the streaming
rate a kernel of this shape reaches on the card. Needs a card.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 4096
TS = (1, 256, 2304, 4096)

_LAUNCH = ("  cfg.numAttrs = 1;\n  return static_cast<int>(cudaLaunchKernelEx(&cfg, "
           "rmsnorm_quant_kernel<VPT, K>")
VARIANTS = {
    "as_is": [],
    # no programmatic dependent launch
    "no_pdl": [(_LAUNCH, _LAUNCH.replace("numAttrs = 1", "numAttrs = 0"))],
    # the row's maximum by shuffle butterflies in place of redux.sync
    "shfl_max": [("    const unsigned m = __reduce_max_sync(0xffffffffu, __float_as_uint(v[k]));\n",
                  "    float mf = v[k];\n    for (int o = 16; o; o >>= 1) "
                  "mf = fmaxf(mf, __shfl_xor_sync(0xffffffffu, mf, o));\n"
                  "    const unsigned m = __float_as_uint(mf);\n"),
                 ("  return __uint_as_float(__reduce_max_sync(0xffffffffu, t));",
                  "  float tf = __uint_as_float(t);\n  for (int o = 16; o; o >>= 1) "
                  "tf = fmaxf(tf, __shfl_xor_sync(0xffffffffu, tf, o));\n  return tf;")],
    # both bounds of the clamp, as K14's quant4
    "clamp2": [("fmaxf(sm90::div_rn(x[e], s, r), -127.f) + 12582912.f",
                "fminf(fmaxf(sm90::div_rn(x[e], s, r), -127.f), 127.f) + 12582912.f")],
    # rint by the conversion instruction (K14's quant4) in place of the add
    "f2i": [("quant4_add(hh[0]", "quant4(hh[0]"), ("quant4_add(hh[4]", "quant4(hh[4]")],
    # drops work: the int8 row is made but not stored (the scale only)
    "no_store": [("*reinterpret_cast<uint2*>(qrow + static_cast<size_t>(v) * VEC) =",
                  "if (hh[0] == 12345.f) *reinterpret_cast<uint2*>(qrow + "
                  "static_cast<size_t>(v) * VEC) =")],
    # drops work: no second reduction, no int8 row (the scale only)
    "no_quant": [("    const float sc = sm90::div_rn(row_max<K>(part, red_max, K * nw), 127.f, r127) + "
                  "1e-8f;",
                  "    const float sc = part[0];\n    if (tid == 0) s[row] = sc;\n"
                  "    if (sc != -1.f) continue;")],
}
OCCUPANCY = r'''
extern "C" int kvz_norm_occupancy(int K, int nthr, int smem, int* n) {
  if (K == 2)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, rmsnorm_quant_kernel<1, 2>, nthr / 2, smem));
  if (K == 4)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, rmsnorm_quant_kernel<1, 4>, nthr / 4, smem));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, rmsnorm_quant_kernel<1, 1>, nthr, smem));
}
'''
ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def build(name, subs, tmp):
    from kvzip_tpu_torch import _build

    csrc = _build.CSRC
    with open(os.path.join(csrc, "fused_act.cu")) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: substitution not found: {old[:60]!r}")
        src = src.replace(old, new)
    i = src.index('extern "C" int kvz_rmsnorm_quant(')
    src = src[:i] + OCCUPANCY + src[i:]
    cu = os.path.join(tmp, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(tmp, f"lib{name}.so")
    return so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def graph_ms(fn, iters=56):
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    from kvzip_tpu_torch.ops import fused_act, sm_count

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    names = args.only.split(",") if args.only else list(VARIANTS)
    rows = [dict(card=card)]
    print(json.dumps(rows[0]), flush=True)
    sms = sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: build(n, VARIANTS[n], tmp) for n in names}
        libs = {}
        for n, (so, p) in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed for {n}:\n{log}")
            libs[n] = ctypes.CDLL(so)
            rows.append(dict(variant=n, ptxas=[ln.strip() for ln in log.splitlines()
                                               if "registers" in ln or "rmsnorm" in ln][-12:]))
            print(json.dumps(rows[-1]), flush=True)
        want = {}
        for T in TS:
            x = (torch.randn(T, D, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            w = (1 + 0.2 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
            q = torch.empty((T, D), dtype=torch.int8, device="cuda")
            s = torch.empty((T, 1), dtype=torch.float32, device="cuda")
            r = dict(variant="torch_cast", T=T, ms=graph_ms(lambda: x.to(torch.int8)))
            rows.append(r)
            print(json.dumps(r), flush=True)
            plans = set()
            for split in (1, 2, 4):
                grid, nthr, K, stages = fused_act.plan_norm(T, D, sms, split)
                plans |= {(K, grid, stages), (K, T, stages), (K, grid, 2)}
            for n in names:
                fn = libs[n].kvz_rmsnorm_quant
                fn.argtypes, fn.restype = ARGS, ctypes.c_int
                for K, grid, stages in sorted(plans):
                    def call(K=K, grid=grid, stages=stages):
                        err = fn(x.data_ptr(), w.data_ptr(), q.data_ptr(), s.data_ptr(), T, D,
                                 1e-5, 0, grid, nthr, K, stages,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{n}: CUDA error {err}")
                    call()
                    torch.cuda.synchronize()
                    h = hashlib.sha256(q.cpu().numpy().tobytes()
                                       + s.cpu().numpy().tobytes()).hexdigest()[:12]
                    want.setdefault(T, h) if n == "as_is" else None
                    occ = ctypes.c_int(0)
                    libs[n].kvz_norm_occupancy(K, nthr, stages * 2 * D, ctypes.byref(occ))
                    r = dict(variant=n, T=T, grid=grid, threads=nthr // K, K=K, stages=stages,
                             resident=occ.value, ms=graph_ms(call), out=h,
                             same_bits=h == want.get(T))
                    rows.append(r)
                    print(json.dumps(r), flush=True)
            del x, q, s
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
