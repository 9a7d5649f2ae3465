#!/usr/bin/env python3
"""Where K4's time goes: ``csrc/ragged_decode.cu`` (with its body,
``csrc/split_decode.cuh``, written in) rebuilt with one change at a time and timed at the smoke's decode shape (qwen2.5-7b, 16,545 live
rows of a 19,456-row cache, T = 1, 28 layers cycled, ``graph_ms``).

    python3 tools/k4_variants.py [--out FILE]

Each variant is the source with a text substitution (``VARIANTS``), built
with the port's nvcc flags into a temporary directory and called through
its C entry with the wrapper's arguments, at S = 33 splits a head (the
unchanged kernel also at 16), and once with %globaltimer stamps of each
CTA's phases (``TIMELINE``). Variants that drop work print their time
only; the others are also held against the plain version (``ops.parity``).
Needs a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H, HKV, D, T = 28, 28, 4, 128, 1
PREFILL, CAPACITY = 16544, 19456

# name -> (substitutions, keeps the function)
VARIANTS = {
    "as_is": ([], True),
    "no_merge": ([("  const int slot = split;\n", "  return;\n  const int slot = split;\n")], False),
    "no_compute": ([("    float s[MT][2][4];\n    const bf16* Vs = src.",
                     "    __syncwarp();\n    continue;\n    float s[MT][2][4];\n"
                     "    const bf16* Vs = src.")], False),
    "stream_only": ([("  __syncthreads();  // every warp is done with its ring: reuse it",
                      "  return;")], False),
    "stages_6": ([("constexpr int NST = 4;", "constexpr int NST = 6;")], True),
    "merge_no_copy": ([("    sm90::mbar_expect_tx(&s_bar[1], val_bytes);",
                        "    sm90::mbar_arrive(&s_bar[1]);\n    if (0) {"),
                       ("                    &s_bar[1]);\n    // one more",
                        "                    &s_bar[1]);\n    }\n    // one more")], False),
    "merge_no_sum": ([("  for (int i = tid; i < nrows * W; i += NW * 32) {\n    const int r = i / W,",
                       "  for (int i = tid; i < 0; i += NW * 32) {\n    const int r = i / W,")], False),
}

# The kernel as it is, with %globaltimer stamps of each CTA's phases:
# 0 entry, 2 key loop done, 5 partial written; in the merging CTAs 6 the
# group's count complete, 3 weights made and the value blocks staged, 7 the
# output written.
TIMELINE = [
    ("using namespace kvz;",
     "using namespace kvz;\n"
     "__device__ unsigned long long kvz_tl[8192 * 16];\n"
     "#define KVZ_MARK(k) do { if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "kvz_tl[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 16 + (k)] = t_; "
     "} } while (0)"),
    ("  const size_t grp = static_cast<size_t>(hk) * RGS + rg;\n",
     "  const size_t grp = static_cast<size_t>(hk) * RGS + rg;\n  KVZ_MARK(0);\n"),
    ("  __syncthreads();  // every warp is done with its ring: reuse it",
     "  __syncthreads();  // every warp is done with its ring: reuse it\n  KVZ_MARK(2);"),
    ("  const int slot = split;\n", "  KVZ_MARK(6);\n  const int slot = split;\n"),
    ("  if (split >= MC) {\n", "  KVZ_MARK(5);\n  if (split >= MC) {\n"),
    ("  sm90::mbar_wait(&s_bar[1], 0);\n", "  sm90::mbar_wait(&s_bar[1], 0);\n  KVZ_MARK(3);\n"),
    ("        __float2bfloat16_rn((a[0] + a[1] + a[2] + a[3]) * s_den[r]);\n  }\n",
     "        __float2bfloat16_rn((a[0] + a[1] + a[2] + a[3]) * s_den[r]);\n  }\n  KVZ_MARK(7);\n"),
]
TIMELINE_READ = """
extern "C" int kvz_tl_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, sdec::kvz_tl, sizeof(sdec::kvz_tl)));
}
"""


def build(name, subs, tmp, tail=""):
    csrc = os.path.join(ROOT, "kvzip_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "ragged_decode.cu")).read().replace(
        '#include "split_decode.cuh"', open(os.path.join(csrc, "split_decode.cuh")).read())
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    src += tail
    cu = os.path.join(tmp, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    from kvzip_tpu_torch import _build
    so = os.path.join(tmp, f"lib{name}.so")
    return so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None, help="comma-separated variants (and/or timeline)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    from kvzip_tpu_torch.ops import OUT_RTOL, parity, ragged_decode
    from tools.attn_profile import graph_ms

    tmp = tempfile.mkdtemp()
    only = args.only.split(",") if args.only else [*VARIANTS, "timeline"]
    jobs = {n: build(n, subs, tmp) for n, (subs, _) in VARIANTS.items() if n in only}
    if "timeline" in only:
        jobs["timeline"] = build("timeline", TIMELINE, tmp, TIMELINE_READ)
    libs = {}
    for n, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps(dict(variant=n, build_failed=log[-3000:])), flush=True)
            continue
        lib = ctypes.CDLL(so)
        fn = lib.kvz_ragged_decode
        fn.argtypes = ragged_decode._ARGS
        libs[n] = (fn, [ln.strip() for ln in log.splitlines() if "registers" in ln], lib)
    timeline = libs.pop("timeline", None)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    kc, vc = rn(L, HKV, CAPACITY, D), rn(L, HKV, CAPACITY, D)
    q = rn(T, H, D)
    lens = torch.full((HKV,), PREFILL, dtype=torch.int32, device="cuda")
    want = ragged_decode.ragged_decode_attend_plain(q.float(), kc[0].float(), vc[0].float(),
                                                    lens, scale=D ** -0.5)

    def launcher(fn, S):
        """A call of the kernel on the next layer's cache (layer 0 first)."""
        part_acc = torch.empty((HKV, 1, S, 32, D), dtype=torch.float32, device="cuda")
        part_ml = torch.empty(HKV * S * 32 * 2 + 4, dtype=torch.float32, device="cuda")
        out = torch.empty_like(q)
        tickets = torch.zeros(2048, dtype=torch.int32, device="cuda")
        cyc = iter(range(10 ** 9))

        def call():
            l = next(cyc) % L
            err = fn(q.data_ptr(), kc[l].data_ptr(), vc[l].data_ptr(), lens.data_ptr(),
                     out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
                     T, H, HKV, CAPACITY, S, D ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
            return out
        return call

    rows = []

    def save(rows):
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)

    for n, (fn, regs, _) in libs.items():
        for S in ((16, 33) if n == "as_is" else (8, 16, 33) if n == "stream_only" else (33,)):
            r = dict(variant=n, S=S, registers=regs)
            if VARIANTS[n][1]:
                got = launcher(fn, S)().clone()
                torch.cuda.synchronize()
                r["parity_ok"] = parity(got, want, OUT_RTOL)["ok"]
            r["ms"] = graph_ms(launcher(fn, S), 56)
            rows.append(r)
            print(json.dumps(r), flush=True)
            save(rows)
    if timeline is not None:
        fn, regs, lib = timeline
        S = 33
        launcher(fn, S)()  # warm, layer 0
        call = launcher(fn, S)
        for _ in range(8):  # layer 7: rows not in L2
            call()
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * (8192 * 16))()
        if lib.kvz_tl_read(host):
            raise RuntimeError("timeline read failed")
        n_cta = HKV * S
        stamps = [[host[c * 16 + k] for c in range(n_cta)] for k in range(8)]
        t0 = min(stamps[0])
        r = dict(variant="timeline", S=S, registers=regs)
        for k in (0, 2, 5, 6, 3, 7):
            v = sorted((t - t0) / 1e3 for t in stamps[k] if t >= t0)
            if v:
                r[f"mark{k}_us"] = dict(n=len(v), min=v[0], median=v[len(v) // 2], max=v[-1])
        rows.append(r)
        print(json.dumps(r), flush=True)
    save(rows)


if __name__ == "__main__":
    main()
