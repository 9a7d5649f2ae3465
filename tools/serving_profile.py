#!/usr/bin/env python3
"""Where the merged decode step's device time goes: per CUDA kernel, one
merged step of four sequences (``serving.MergedBatch``) beside each
state's own single-sequence step (``engine.DecodeStep``) on the same
states, at qwen2.5-7b's full width (random weights from a seed).

    python3 tools/serving_profile.py [--modes bf16,quant] [--ctx 8192] [--steps 5]

Four contexts of ``--ctx`` random tokens are prefilled without a scoring
pass (scores drawn from a seed: a step's time depends on how many rows
were kept, not on which) and pruned at pair 0.3, 0.4, 0.5 and 0.6 into
the pool; ``quant`` is the flagship configuration (int4 KV, W4A8, int8
embedding and head). For the merged step and for each single state it
prints one JSON line: the step's device ms (CUDA events around 20
replays of its CUDA graph, its answer ended so nothing advances) and the
device microseconds a step of each CUDA kernel (``torch.profiler`` over
``--steps`` eager runs of the same step, which launch the same kernels),
with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

RATIOS = (0.3, 0.4, 0.5, 0.6)
QUANT = dict(kv_quant="int4", weight_quant="w4a8", embed_quant="int8")


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_us(fn, calls: int) -> dict:
    """Device microseconds a call of each CUDA kernel fn launches."""
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
            out[e.key[:90]] = round(t / calls, 2)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="bf16,quant")
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import gc

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the profile needs one card")
    from kvzip_tpu_torch import serving
    from kvzip_tpu_torch.config import resolve_config
    from kvzip_tpu_torch.engine import Engine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cfg = resolve_config("qwen2.5-7b")
    for mode in args.modes.split(","):
        eng = Engine("qwen2.5-7b", config=cfg, device="cuda", max_new_tokens=32, seed=0,
                     **(QUANT if mode == "quant" else {}))
        rng = np.random.default_rng(0)
        gen = torch.Generator("cuda").manual_seed(0)
        states = []
        for ratio in RATIOS:
            st = eng.prefill(rng.integers(0, cfg.vocab_size, args.ctx).astype(np.int32),
                             do_score=False)
            st.score = torch.rand((cfg.num_layers, cfg.num_kv_heads, st.ctx_len),
                                  generator=gen, device="cuda")
            eng.prune(st, ratio, "pair")
            states.append(st)
        queries = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32) for _ in states]
        for q, st in zip(queries, states):
            eng.generate_ids(q, st, max_new_tokens=2)  # captures each state's step
        batch = serving.MergedBatch(eng, states)
        batch.check_room(24 + 32)
        batch.ingest(queries)
        steps = [("merged", batch.decode_step())] + [
            (f"single_{i}", eng.decode_step(st)) for i, st in enumerate(states)]
        for tag, step in steps:
            step.done.fill_(1)  # the answer ended: the same kernels, nothing advances
            us = kernel_us(step.step, args.steps)
            print(json.dumps(dict(card=card, mode=mode, step=tag, ctx=args.ctx,
                                  device_ms=time_ms(step.graph.replay, 20),
                                  kernel_us_sum=round(sum(us.values()), 1), kernels=us)),
                  flush=True)
        del eng, states, batch, steps
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
