#!/usr/bin/env python3
"""Device times of K14 (``silu_mul_quant``) and K13 (``rmsnorm_quant``, the
control) at ``chip_smoke.py``'s W8A8-KV4 widths (llama3.1-8b: F 14,336,
D 4,096), each beside its byte bound, with the SASS instructions an element
of each kernel.

    python3 tools/fused_act_profile.py [--root DIR] [--out FILE] [--forms]

``--root`` imports ``kvzip_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so two versions can be
timed in one run on one card. For each shape it prints one JSON line: the
wrapper's device time from a CUDA-graph replay of 56 calls (``graph_ms``,
as the smoke takes it), the device time of each CUDA kernel it launches
from ``torch.profiler`` (``kernels``: name -> mean us a call), the byte
bound (bf16 in, int8 and a float32 scale a row out, at 3.35 TB/s), the
form K14's plan chose (where the checkout has one), ``ops.quant_parity``
against the plain version, and a hash of the output's bytes (so two
checkouts' outputs can be compared bit for bit). K14 at T 1, 2, 4, 16, 24,
64, 256, 1024, 2304 and 4096, K13 at T 1, 4, 16, 64, 256, 1024, 2304 and
4096 (the T the smoke's W8A8-KV4 path gives them, and decode's neighbours). ``--forms`` also times K14 in every
form its entry takes (clusters of 4-16 CTAs, the row form) at T 1-192
around the plan's switch, on a checkout with ``fused_act.plan``. Last, per kernel function of the
library: its SASS instructions, and for each loop (a backward branch) the
instructions in its body and, per 16-byte vector of 8 elements, an
element's share (static counts: a slow path that no element takes is
counted too). Needs a card.
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

F_W8, D_W8 = 14336, 4096
FORMS_T = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 100, 128, 192)  # around the form switch
PEAK_BYTES = 3.35e12


def graph_ms(fn, iters):
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


def kernel_us(fn, calls):
    """Mean device microseconds per wrapper call of each CUDA kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            out[e.key[:80]] = t / calls
    return out


def digest(*tensors):
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sass_counts(lib):
    """Per kernel function: SASS instructions, and each loop's body (the
    instructions from a backward branch's target to the branch)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, fn, ins = {}, None, []

    def close():
        if fn is None:
            return
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                loops.append(sum(1 for a, _ in ins if lo <= a <= addr))
        out[fn] = dict(instructions=len(ins), loop_bodies=loops,
                       per_element=[round(n / 8, 2) for n in loops])

    for ln in sass.splitlines():
        if "Function :" in ln:
            close()
            fn, ins = ln.split("Function :")[1].strip(), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if fn and m:
            ins.append((int(m.group(1), 16), m.group(2)))
    close()
    return {k: v for k, v in out.items() if "quant" in k}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--forms", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from kvzip_tpu_torch import _build
    from kvzip_tpu_torch.ops import fused_act, quant_parity, sm_count

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    logs = _build.build_all(("fused_act",))
    rows = [dict(card=card, root=os.path.abspath(args.root), torch=torch.__version__,
                 ptxas=[ln.strip() for ln in logs["fused_act"].splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling" in ln])]
    print(json.dumps(rows[0]), flush=True)

    def emit(r):
        rows.append(r)
        print(json.dumps(r), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = sm_count(torch.device("cuda"))
    has_plan = hasattr(fused_act, "plan")

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    for T in (1, 2, 4, 16, 24, 64, 256, 1024, 2304, 4096):
        gate, up = rn(T, F_W8) * 3, rn(T, F_W8)
        got = fused_act.silu_mul_quant(gate, up)
        par = quant_parity(*got, *fused_act.silu_mul_quant_plain(gate, up))
        nbytes = 2 * 2 * T * F_W8 + T * F_W8 + 4 * T
        r = dict(kernel="silu_mul_quant", T=T, F=F_W8,
                 ms=graph_ms(lambda: fused_act.silu_mul_quant(gate, up), 56),
                 kernels=kernel_us(lambda: fused_act.silu_mul_quant(gate, up), 56),
                 bound_ms=nbytes / PEAK_BYTES * 1e3, out=digest(*got),
                 parity={k: par[k] for k in ("ok", "step_share", "scale_rel_err")})
        if has_plan:
            r["plan"] = fused_act.plan(T, F_W8, sms)
        emit(r)
        del gate, up
    for T in (FORMS_T if args.forms and has_plan else ()):
        gate, up = rn(T, F_W8) * 3, rn(T, F_W8)
        want = digest(*fused_act.silu_mul_quant(gate, up))
        for C in (16, 8, 4, 0):
            per = -(-(F_W8 // 8) // C) if C else 0
            if C and (per > fused_act.CL_THREADS * fused_act.CL_VPT or T * C > 4 * sms):
                continue
            nthr = min(fused_act.CL_THREADS, -(-per // 32) * 32) if C else fused_act.RF_THREADS
            got = fused_act._launch_act(gate, up, "silu", C, nthr)
            emit(dict(kernel="silu_mul_quant form", T=T, C=C, threads=nthr,
                      plan=fused_act.plan(T, F_W8, sms),
                      ms=graph_ms(lambda: fused_act._launch_act(gate, up, "silu", C, nthr), 56),
                      same_bits=digest(*got) == want))
        del gate, up
    for T in (1, 4, 16, 64, 256, 1024, 2304, 4096):
        x = rn(T, D_W8) * 3
        w = (1 + 0.2 * torch.randn(D_W8, generator=gen, device="cuda")).to(torch.bfloat16)
        got = fused_act.rmsnorm_quant(x, w, 1e-5)
        par = quant_parity(*got, *fused_act.rmsnorm_quant_plain(x, w, 1e-5))
        nbytes = 2 * T * D_W8 + 2 * D_W8 + T * D_W8 + 4 * T
        emit(dict(kernel="rmsnorm_quant", T=T, D=D_W8,
                  ms=graph_ms(lambda: fused_act.rmsnorm_quant(x, w, 1e-5), 56),
                  kernels=kernel_us(lambda: fused_act.rmsnorm_quant(x, w, 1e-5), 56),
                  bound_ms=nbytes / PEAK_BYTES * 1e3, out=digest(*got),
                  parity={k: par[k] for k in ("ok", "step_share", "scale_rel_err")}))
    emit(dict(sass=sass_counts(_build._lib_path("fused_act"))))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
