#!/usr/bin/env python3
"""What NCCL answers when two ranks of one group sit on the same card.

    python3 tools/nccl_probe.py [--ranks 2] [--timeout 120]

Spawns ``--ranks`` processes, each on ``cuda:0`` (NCCL, a FileStore in a
temporary directory), and runs one all-reduce; prints one JSON line per
rank with its outcome (the sum, or the error's type and first line) and
a last line with the card's name and power limit. A rank still running
after ``--timeout`` seconds is killed and reported as hung.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _rank(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    res = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        x = torch.ones(4, device="cuda") * (rank + 1)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        res.update(ok=True, sum=x.tolist())
        dist.destroy_process_group()
    except Exception as e:  # the outcome is what this probe reports
        res.update(ok=False, error=type(e).__name__, message=str(e).splitlines()[0][:300])
    with open(out, "w") as f:
        json.dump(res, f)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120)
    args = ap.parse_args()
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp()
    ctx = mp.get_context("spawn")
    procs, outs = [], []
    for r in range(args.ranks):
        out = os.path.join(tmp, f"rank{r}.json")
        p = ctx.Process(target=_rank, args=(r, args.ranks, os.path.join(tmp, "store"), out))
        p.start()
        procs.append(p)
        outs.append(out)
    t0 = time.time()
    for r, (p, out) in enumerate(zip(procs, outs)):
        p.join(max(1.0, args.timeout - (time.time() - t0)))
        if p.is_alive():
            p.kill()
            p.join()
            print(json.dumps({"rank": r, "ok": False, "error": "hung",
                              "message": f"killed after {args.timeout} s"}))
        elif os.path.exists(out):
            print(open(out).read())
        else:
            print(json.dumps({"rank": r, "ok": False, "error": "exited",
                              "message": f"exit code {p.exitcode}"}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
