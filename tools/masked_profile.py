#!/usr/bin/env python3
"""Device time of the masked attention route (``ops/attention.py``:
``attend_blockwise``, ``attend_dense``; torch ops, no kernel of the port)
at the shapes ``chip_smoke.py``'s dense routes give it:

- qwen2.5-7b retain decode: 28 heads over 4 kv heads, head_dim 128, an
  18,944-row cache with 16,544 live rows a head and ~30% of the context
  valid, T = 1 (a decode step) and 16 (a query chunk);
- the dense serving batch: four such caches of 10,752 rows (8,352 live)
  stacked over 16 kv heads, T = 1;
- llama3.2-1b: 32 heads over 8, head_dim 64, a 4,096-query prefill chunk
  after 12,288 rows of an 18,944-row cache, and T = 1 on its 7,168-row
  compacted cache.

    python3 tools/masked_profile.py [--root DIR] [--out FILE]

Beside each ``attend_blockwise`` shape of at most 16 queries stands the
same call with one key block of the whole capacity (``kv_block`` = the
capacity: one score product and one p.v product over every key, the
route's first form), so the two forms are timed in one call on one card.
``--root`` imports ``kvzip_tpu_torch`` from another checkout (a commit
unpacked with ``git archive``). One JSON line a shape: the device time of one call from
a CUDA-graph replay of many (``graph_ms``, as the smoke takes kernel
times), and the device time of each CUDA kernel one eager call launches
(``kernels``: name -> us a call, from ``torch.profiler``, the eight
largest). Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = [  # (name, fn, T, H, Hkv, D, capacity, live rows, valid share)
    ("qwen_retain_decode", "attend_blockwise", 1, 28, 4, 128, 18944, 16544, 0.3),
    ("qwen_retain_decode_dense", "attend_dense", 1, 28, 4, 128, 18944, 16544, 0.3),
    ("qwen_retain_chunk", "attend_blockwise", 16, 28, 4, 128, 18944, 16544, 0.3),
    ("serving_dense_step", "attend_blockwise", 1, 112, 16, 128, 10752, 8352, 0.45),
    ("llama1b_prefill_chunk", "attend_blockwise", 4096, 32, 8, 64, 18944, 12288, 1.0),
    ("llama1b_decode", "attend_blockwise", 1, 32, 8, 64, 7168, 5000, 1.0),
]


def graph_ms(fn, iters: int) -> float:
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


def kernels_us(fn, calls: int = 5) -> dict:
    """Device us a call of each CUDA kernel fn() launches, the eight
    largest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / calls) for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0 and "CUDA" in str(e.device_type)]
    rows.sort(key=lambda r: -r[1])
    return {k[:90]: round(v, 2) for k, v in rows[:8]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.root))
    from kvzip_tpu_torch.ops import attention

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for name, fn_name, T, H, Hkv, D, C, live, share in SHAPES:
        fn = getattr(attention, fn_name)
        q = torch.randn(T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(Hkv, C, D, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        lens = torch.full((Hkv,), live, dtype=torch.int32, device="cuda")
        valid = torch.rand(Hkv, C, generator=gen, device="cuda") < share

        forms = {"": {}}
        if fn_name == "attend_blockwise" and T <= 16:
            forms["_one_block"] = dict(kv_block=C)
        for suffix, kw in forms.items():
            def call(kw=kw):
                return fn(q, k, v, lens, valid, scale=D ** -0.5, **kw)

            row = dict(card=card, root=os.path.abspath(args.root), shape=name + suffix,
                       fn=fn_name, T=T, H=H, Hkv=Hkv, D=D, capacity=C,
                       graph_ms=graph_ms(call, 10 if T > 64 else 50), kernels=kernels_us(call))
            print(json.dumps(row), flush=True)
            out.append(row)
    if args.out:
        with open(args.out, "a") as f:
            for row in out:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
