#!/usr/bin/env python3
"""Where K8's time goes inside one call: builds ``csrc/w4a8.cu`` with
``-DK8_STAMPS`` (each CTA's thread 0 writes ``%globaltimer`` at its start,
once its rows are quantized, when its first stage has landed, after its
last unit's products and at its end) and runs K8 at qwen2.5-7b's four v2
linears and the int4 lm_head at T 1 and 4, after a warm-up call on the
same layer. Prints one JSON line a shape: for each phase the first CTA,
the 10th, 50th and 90th percentiles and the last, in us after the first
CTA's start, the call's device
ms (CUDA events around the stamped call) and the plan. Needs a card.

    python3 tools/w4a8_stamps.py [--root DIR]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

PHASES = ("start", "rows_quantized", "first_stage", "last_unit", "end")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch

    sys.path.insert(0, os.path.abspath(args.root))
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
                col = rel[:, i].sort().values
                row[ph] = [round(col[int(q * (len(col) - 1))].item(), 2)
                           for q in (0, 0.1, 0.5, 0.9, 1)]
            print(json.dumps(row), flush=True)
        del q4, s2


if __name__ == "__main__":
    main()
