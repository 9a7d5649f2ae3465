#!/usr/bin/env python3
"""Where K7's time goes: ``csrc/int4_decode.cuh`` (the body K7 and K11
share) rebuilt with one change at a time and timed at the smoke's evicted
pool (qwen2.5-7b, 28 layers of ~20,000 int4 rows over 4 kv heads, tail 40
of 768, T = 1, layers cycled, ``graph_ms``), exact and q8.

    python3 tools/int4_decode_variants.py [--out FILE] [--only as_is,timeline,...]

Each variant is the header with a text substitution (``VARIANTS``), built
beside a copy of ``pool_decode_int4.cu`` with the port's nvcc flags into a
temporary directory and called through its C entry with the wrapper's
arguments, at the planned number of splits S (``as_is`` also at other S),
and once with %globaltimer stamps of each CTA's phases (``TIMELINE``).
Variants that drop work print their time only; the others are also held
against the plain version (``ops.parity``). Needs a card.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, H, HKV, D, T = 28, 28, 4, 128, 1
PREFILL, TCAP, TAIL = 16544, 768, 40

# name -> (substitutions in int4_decode.cuh, keeps the function)
VARIANTS = {
    "as_is": ([], True),
    "no_merge": ([("  // This CTA's slice of the row group's output: units u0 ... u1 - 1 of",
                   "  return;\n  // This CTA's slice")], False),
    "no_wait": ([("    while (static_cast<int>(sm90::ld_relaxed(count)) < S)",
                  "    while (false)")], False),
    "no_compute": ([("    if (w.h_lo > w.h_hi) continue;\n    if (!tail) {",
                     "    continue;\n    if (!tail) {")], False),
}

# The kernel with %globaltimer stamps of each CTA's phases: 0 entry, 1 the
# first stage landed, 2 the key loop done, 7 the key groups' rows stored,
# 3 the partial written, 4 the group's count complete, 5 the weights made,
# 6 the output slice written.
TIMELINE = [
    ("namespace kvz {\n\nusing sm90::div_rn;",
     "__device__ unsigned long long kvz_tl[8192 * 8];\n"
     "#define KVZ_MARK(k) do { if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "kvz_tl[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 8 + (k)] = t_; "
     "} } while (0)\n"
     "namespace kvz {\n\nusing sm90::div_rn;"),
    ("  const int grp = sb * a.rgs + rg;\n",
     "  const int grp = sb * a.rgs + rg;\n  KVZ_MARK(0);\n"),
    ("    sm90::named_bar(1 + kg, GTH);  // stage k landed",
     "    sm90::named_bar(1 + kg, GTH);\n    if (k == 0) KVZ_MARK(1);  // stage k landed"),
    ("  __syncthreads();  // every group is done with its ring: reuse it",
     "  __syncthreads();  // every group is done with its ring: reuse it\n  KVZ_MARK(2);"),
    ("          make_float2(st.acc[nt][2 * i], st.acc[nt][2 * i + 1]);\n  }\n  __syncthreads();\n",
     "          make_float2(st.acc[nt][2 * i], st.acc[nt][2 * i + 1]);\n  }\n  __syncthreads();\n"
     "  KVZ_MARK(7);\n"),
    ("  unsigned* count = a.tickets + grp;\n  __syncthreads();\n",
     "  unsigned* count = a.tickets + grp;\n  __syncthreads();\n  KVZ_MARK(3);\n"),
    ("    if (sm90::atom_add(count, 1u) == 2u * S - 1) *count = 0u;\n  }\n  __syncthreads();\n",
     "    if (sm90::atom_add(count, 1u) == 2u * S - 1) *count = 0u;\n  }\n  __syncthreads();\n"
     "  KVZ_MARK(4);\n"),
    ("    if (lane == 0) inv[rr] = 1.f / fmaxf(L, 1e-37f);\n  }\n  __syncthreads();\n",
     "    if (lane == 0) inv[rr] = 1.f / fmaxf(L, 1e-37f);\n  }\n  __syncthreads();\n"
     "  KVZ_MARK(5);\n"),
    ("  if (nu >= NTHR) {\n    for (int u = u0 + tid; u < u1; u += NTHR) write(u, sum(u, 0, 1));\n"
     "    return;\n  }",
     "  if (nu >= NTHR) {\n    for (int u = u0 + tid; u < u1; u += NTHR) write(u, sum(u, 0, 1));\n"
     "    KVZ_MARK(6);\n    return;\n  }"),
    ("    write(u0 + tid, t);\n  }\n}", "    write(u0 + tid, t);\n  }\n  KVZ_MARK(6);\n}"),
]
TIMELINE_READ = """
extern "C" int kvz_tl_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, kvz_tl, sizeof(kvz_tl)));
}
"""


def build(name, subs, tmp, tail=""):
    csrc = os.path.join(ROOT, "kvzip_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "int4_decode.cuh")).read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    d = os.path.join(tmp, name)
    os.makedirs(d)
    with open(os.path.join(d, "int4_decode.cuh"), "w") as f:
        f.write(src)
    cu = os.path.join(d, "pool_decode_int4.cu")
    shutil.copy(os.path.join(csrc, "pool_decode_int4.cu"), cu)
    with open(cu, "a") as f:
        f.write(tail)
    from kvzip_tpu_torch import _build
    so = os.path.join(d, f"lib{name}.so")
    return so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None, help="comma-separated variants (and/or timeline)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    from kvzip_tpu_torch.ops import OUT_RTOL, int4_decode, parity, pool_decode, sm_count
    from kvzip_tpu_torch.pool import POOL_ALIGN, plan_offsets
    from tools.attn_profile import graph_ms, quant

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
        fn = lib.kvz_pool_decode_int4
        fn.argtypes = pool_decode._ARGS_INT4
        fn.restype = ctypes.c_int
        libs[n] = (fn, [ln.strip() for ln in log.splitlines() if "registers" in ln], lib)
    timeline = libs.pop("timeline", None)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows_h = torch.randint(int(0.2 * PREFILL), int(0.4 * PREFILL), (L, HKV),
                           generator=torch.Generator().manual_seed(2))
    per_layer = rows_h.sum(1).numpy()
    off, alloc, max_rows = plan_offsets(per_layer, POOL_ALIGN)
    rh = torch.full((alloc,), -1, dtype=torch.int32)
    for l in range(L):
        rh[int(off[l]):int(off[l]) + int(per_layer[l])] = torch.repeat_interleave(
            torch.arange(HKV, dtype=torch.int32), rows_h[l])
    rh = rh.cuda()
    f32 = torch.float32
    pool = (*quant(rn, alloc, dtype=f32), *quant(rn, alloc, dtype=f32))
    kt, vt = rn(L, HKV, TCAP, D), rn(L, HKV, TCAP, D)
    geo = (torch.from_numpy(off).cuda(), torch.from_numpy(per_layer.astype(np.int32)).cuda())
    q = rn(T, H, D)
    mtc, groups, S_plan = int4_decode.plan(H * T, 1, max_rows, sm_count(q.device))

    def launcher(fn, S, q8):
        """A call of the kernel on the next layer (layer 0 first)."""
        part_acc = torch.empty(groups * S * 16 * mtc * D, dtype=f32, device="cuda")
        part_ml = torch.empty(groups * S * 16 * mtc * 2, dtype=f32, device="cuda")
        out = torch.empty_like(q)
        tickets = torch.zeros(1024, dtype=torch.int32, device="cuda")
        cyc = iter(range(10 ** 9))

        def call():
            l = next(cyc) % L
            err = fn(*[a.data_ptr() for a in (q, *pool, rh, *geo, kt, vt)], None,
                     out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                     tickets.data_ptr(), T, H, HKV, TCAP, l, TAIL, S, mtc, groups, int(q8),
                     D ** -0.5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
            return out
        return call

    rows = []

    def save():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)

    for q8 in (False, True):
        want = pool_decode.pool_decode_attend_int4_plain(
            q.float(), *pool, rh, *geo, kt.float(), vt.float(), TAIL, 0, scale=D ** -0.5,
            q8=q8, with_slack=q8)
        want, slack = want if q8 else (want, None)
        for n, (fn, regs, _) in libs.items():
            for S in ((S_plan, 33, 66, 132) if n == "as_is" else (S_plan,)):
                r = dict(variant=n, q8=q8, S=S, registers=regs)
                if VARIANTS[n][1]:
                    got = launcher(fn, S, q8)().clone()
                    torch.cuda.synchronize()
                    r["parity_ok"] = parity(got, want, OUT_RTOL, slack)["ok"]
                r["ms"] = graph_ms(launcher(fn, S, q8), 56)
                rows.append(r)
                print(json.dumps(r), flush=True)
                save()
        if timeline is not None:
            fn, regs, lib = timeline
            call = launcher(fn, S_plan, q8)
            for _ in range(8):  # layer 7: rows not in L2
                call()
            torch.cuda.synchronize()
            host = (ctypes.c_ulonglong * (8192 * 8))()
            if lib.kvz_tl_read(host):
                raise RuntimeError("timeline read failed")
            stamps = [[host[c * 8 + k] for c in range(groups * S_plan)] for k in range(8)]
            t0 = min(stamps[0])
            r = dict(variant="timeline", q8=q8, S=S_plan, registers=regs)
            for k in range(8):
                v = sorted((t - t0) / 1e3 for t in stamps[k] if t >= t0)
                if v:
                    r[f"mark{k}_us"] = dict(n=len(v), min=v[0], median=v[len(v) // 2],
                                            max=v[-1])
            rows.append(r)
            print(json.dumps(r), flush=True)
    save()


if __name__ == "__main__":
    main()
