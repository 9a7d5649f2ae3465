#!/usr/bin/env python3
"""The command line's demo scenario on the card, its one-time phases timed
apart: ``python -m kvzip_tpu_torch.cli demo --ctx_tokens N`` stamps
prefill and scoring as one phase (``Engine.prefill`` scores too); this
builds the demo's engine and random context (the same seed, 42) and times
``prefill(do_score=False)``, ``scoring`` and ``prune(0.3, "pair")`` each
between two synchronizes, with the KV bytes and the peak device memory.

    python3 tools/demo_phases.py --model qwen2.5-7b --ctx_tokens 131072 \\
        [--kv_quant int4 --weight_quant w4a8 --embed_quant int8]

Prints the card's name and power limit, then one JSON line. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="qwen2.5-7b")
    p.add_argument("--ctx_tokens", type=int, default=131072)
    p.add_argument("--kv_quant", default="none")
    p.add_argument("--weight_quant", default="none")
    p.add_argument("--embed_quant", default="none")
    p.add_argument("--prefill_chunk", type=int, default=16384)
    args = p.parse_args()

    import numpy as np
    import torch

    from kvzip_tpu_torch.engine import Engine

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # the demo's engine (cli.cmd_demo with its default 64 decode tokens)
    eng, init_s = timed(lambda: Engine(args.model, kv_quant=args.kv_quant,
                                       weight_quant=args.weight_quant,
                                       embed_quant=args.embed_quant, max_new_tokens=64,
                                       decode_budget=64 + 256))
    rng = np.random.default_rng(42)
    context = rng.integers(1, eng.config.vocab_size - 10, size=args.ctx_tokens).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    st, prefill_s = timed(lambda: eng.prefill(context, prefill_chunk_size=args.prefill_chunk,
                                              do_score=False))
    dense_gb = st.used_gb()
    _, scoring_s = timed(lambda: eng.scoring(st, st.ctx_ids))
    (_, kept), prune_s = timed(lambda: eng.prune(st, 0.3, "pair"))
    print(json.dumps(dict(
        model=args.model, ctx_tokens=args.ctx_tokens, kv_quant=args.kv_quant,
        weight_quant=args.weight_quant, embed_quant=args.embed_quant, init_s=init_s,
        prefill_s=prefill_s, prefill_tok_s=(args.ctx_tokens + st.sink) / prefill_s,
        scoring_s=scoring_s, prune_s=prune_s, kept_ratio=kept, kv_gb_dense=dense_gb,
        kv_gb_pruned=st.used_gb(), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
