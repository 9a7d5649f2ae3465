"""Readings for the limits of ``correct``: the cell's run (its window, its
sample and the comparison, as ``run.py`` runs them) on several seeds in one
process, each with the control beside it (``--control 1``: the reference
one precision step below the configuration's, read at the tokens it puts
first). Prints one JSON line a seed; nothing of it is a benchmark result.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 --seconds 5 --control 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.harness import forbidden_modules, load_json, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--control-as", default=None,
                    help="read another precision in the control's place (a witness: bf16)")
    args = ap.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    for s in args.seeds.split(","):
        t0 = time.time()
        over = {"config": {"control": args.control_as}} if args.control_as else None
        r = run_cell(bench, args.workload, int(s), args.seconds, False, t0,
                     controls=bool(args.control), overrides=over)
        print(json.dumps({"seed": int(s), "correct": r["correct"], "failed": r["failed"],
                          "readings": r["readings"], "metrics": r["metrics"],
                          "run_s": time.time() - t0}), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
