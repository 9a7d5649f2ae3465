"""Run one cell of ``BENCHMARK.json`` once; the last line of standard
output is the result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks``: each number
compared beside its limit, also the last lines of standard error).

    python3 -m portbench.run --workload qwen3-8b-bf16.ingest --seed 7 --seconds 40 --trace 0

Exits non-zero with no result where there is no CUDA card or fewer than
the cell asks for, where the program cannot be imported, and where JAX or
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench.harness import forbidden_modules, load_json, process_start, run_cell

T_PROCESS = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    bench = load_json("BENCHMARK.json")
    spec = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if spec is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["chips"]):
        print(f"needs {spec['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import kvzip_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program cannot be imported: {exc}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    readings = result.pop("readings")
    print("readings: " + json.dumps(readings), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
