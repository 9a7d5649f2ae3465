#!/usr/bin/env python3
"""Where K8's or K12's time goes inside one call.

K8: builds ``csrc/w4a8.cu`` with ``-DK8_STAMPS`` (each CTA's thread 0
writes ``%globaltimer`` at its start, once its rows are quantized, when
its first stage has landed, after its last unit's products and at its
end) and runs K8 at qwen2.5-7b's four v2 linears and the int4 lm_head at
T 1 and 4, after a warm-up call on the same layer.

K12 (``--k12``): builds ``csrc/w4a8_fused.cu`` with ``-DK12_STAMPS`` (each
CTA's thread 0 stamps every phase boundary: a product's activations
quantized and its last unit done, before and after each of the seven grid
barriers, the row phases' ends) and runs K12 on a 2-layer stack of
qwen2.5-7b's widths at T 1, 4 and 8 (layer 0, the next layer's qkv), after
a warm-up call on layer 1. Each line also sums, per CTA, the time spent
waiting at the barriers (``wait_us``: after minus before, the spread over
the CTAs).

Prints one JSON line a shape: for each phase the first CTA, the 10th, 50th
and 90th percentiles and the last, in us after the first CTA's start, the
call's device ms (CUDA events around the stamped call) and the plan.
Needs a card.

    python3 tools/w4a8_stamps.py [--root DIR] [--k12]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

PHASES = ("start", "rows_quantized", "first_stage", "last_unit", "end")
K12_PHASES = ("start", "o_ready", "o_done", "bar1", "row2", "bar2", "gu_ready", "gu_done", "bar3",
              "silu", "bar4", "dn_ready", "dn_done", "bar5", "row6", "bar6", "qkv_ready",
              "qkv_done", "bar7", "end")
# (before, after) of each grid barrier in K12_PHASES
K12_BARRIERS = ((2, 3), (4, 5), (7, 8), (9, 10), (12, 13), (14, 15), (17, 18))


def spread(col):
    """First, 10th, 50th and 90th percentile and last of a sorted column."""
    return [round(col[int(q * (len(col) - 1))].item(), 2) for q in (0, 0.1, 0.5, 0.9, 1)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--k12", action="store_true", help="stamp K12 instead of K8")
    args = ap.parse_args()
    import torch

    sys.path.insert(0, os.path.abspath(args.root))
    if args.k12:
        return k12(args)
    from kvzip_tpu_torch import _build
    from kvzip_tpu_torch.ops import sm_count, w4a8_v2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    os.makedirs(_build.BUILD, exist_ok=True)
    lib = os.path.join(_build.BUILD, "libw4a8_stamps.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DK8_STAMPS", "-o", lib,
                    os.path.join(_build.CSRC, "w4a8.cu")], check=True, capture_output=True)
    so = ctypes.CDLL(lib)
    fn = so.kvz_w4a8
    fn.argtypes, fn.restype = w4a8_v2._ARGS, ctypes.c_int
    real = _build.kernel
    _build.kernel = lambda name, sym, argtypes: fn if name == "w4a8" else real(name, sym, argtypes)
    sms = sm_count(torch.device("cuda"))
    buf = torch.zeros(4 * sms * 8, dtype=torch.int64, device="cuda")
    assert so.kvz_w4a8_stamps(ctypes.c_void_p(buf.data_ptr())) == 0
    print(json.dumps(dict(card=card, root=os.path.abspath(args.root))), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = dict(wqkv=(3584, 4608), wo=(3584, 3584), w_gateup=(3584, 37888),
                  w_down=(18944, 3584), lm_head=(3584, 152064))
    for name, (IN, OUT) in shapes.items():
        half, Gp8 = OUT // 2, -(-IN // 128 // 8) * 8
        q4 = torch.randint(0, 256, (1, IN, half), dtype=torch.uint8, device="cuda", generator=gen)
        s2 = (torch.rand(1, 2, Gp8, half, device="cuda", generator=gen) * 0.002).to(torch.bfloat16)
        for T in (1, 4):
            x = torch.randn(T, IN, device="cuda", generator=gen).to(torch.bfloat16)
            w4a8_v2.w4a8_matmul_stacked_v2(x, q4, s2, s2, 0)
            torch.cuda.synchronize()
            buf.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            w4a8_v2.w4a8_matmul_stacked_v2(x, q4, s2, s2, 0)
            b.record()
            torch.cuda.synchronize()
            p = w4a8_v2.plan(T, half, IN // 128, sms)
            st = buf.view(4 * sms, 8)[:p["grid"], :len(PHASES)].cpu().double()
            t0 = st[:, 0].min()
            rel = (st - t0) / 1e3
            row = dict(shape=name, T=T, event_ms=a.elapsed_time(b),
                       plan={k: p[k] for k in ("nt", "occ", "inq", "gps", "S", "grid")})
            for i, ph in enumerate(PHASES):
                row[ph] = spread(rel[:, i].sort().values)
            print(json.dumps(row), flush=True)
        del q4, s2


def k12(args):
    import torch

    from kvzip_tpu_torch import _build
    from kvzip_tpu_torch.ops import w4a8_fused

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    os.makedirs(_build.BUILD, exist_ok=True)
    lib = os.path.join(_build.BUILD, "libw4a8_fused_stamps.so")
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DK12_STAMPS", "-o", lib,
                            os.path.join(_build.CSRC, "w4a8_fused.cu")], check=True,
                           capture_output=True, text=True)
    ptxas = [ln.strip() for ln in built.stdout.splitlines() + built.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    so = ctypes.CDLL(lib)
    real = _build.kernel

    def kernel(name, sym, argtypes):
        if name != "w4a8_fused":
            return real(name, sym, argtypes)
        fn = getattr(so, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    _build.kernel = kernel
    dev = torch.device("cuda")
    grid = w4a8_fused._grid(dev)
    buf = torch.zeros(grid * 24, dtype=torch.int64, device="cuda")
    assert so.kvz_w4a8_fused_stamps(ctypes.c_void_p(buf.data_ptr())) == 0
    print(json.dumps(dict(card=card, root=os.path.abspath(args.root), kernel="w4a8_layer_fused",
                          grid=grid, ptxas=ptxas)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, D, I, HD, QKV = 2, 3584, 18944, 3584, 4608
    ws = []
    for IN, OUT in ((HD, D), (D, 2 * I), (I, D), (D, QKV)):
        half, Gp8 = OUT // 2, -(-IN // 128 // 8) * 8
        ws.append(dict(q4=torch.randint(0, 256, (L, IN, half), dtype=torch.uint8, device="cuda",
                                        generator=gen),
                       s2=(torch.rand(L, 2, Gp8, half, device="cuda", generator=gen) * 0.002
                           ).to(torch.bfloat16),
                       z2=(-0.001 * torch.rand(L, 2, Gp8, half, device="cuda", generator=gen)
                           ).to(torch.bfloat16)))
    ln = torch.ones(L, D, dtype=torch.bfloat16, device="cuda")
    for T in (1, 4, 8):
        x = (0.5 * torch.randn(T, D, device="cuda", generator=gen)).to(torch.bfloat16)
        attn = (0.3 * torch.randn(T, HD, device="cuda", generator=gen)).to(torch.bfloat16)
        w4a8_fused.w4a8_layer_fused(x, attn, ln, ln, *ws, 1, eps=1e-6, qkv_layer=0)
        torch.cuda.synchronize()
        buf.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        w4a8_fused.w4a8_layer_fused(x, attn, ln, ln, *ws, 0, eps=1e-6, qkv_layer=1)
        b.record()
        torch.cuda.synchronize()
        st = buf.view(grid, 24)[:, :len(K12_PHASES)].cpu().double()
        rel = (st - st[:, 0].min()) / 1e3
        p = w4a8_fused.plan(T, ((HD, D // 2), (D, I), (I, D // 2), (D, QKV // 2)), grid)
        row = dict(T=T, event_ms=a.elapsed_time(b),
                   plan=[{k: pr[k] for k in ("S", "gps", "n_items")} for pr in p["products"]])
        for i, ph in enumerate(K12_PHASES):
            row[ph] = spread(rel[:, i].sort().values)
        waits = sum(rel[:, j] - rel[:, i] for i, j in K12_BARRIERS).sort().values
        row["wait_us"] = spread(waits)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
