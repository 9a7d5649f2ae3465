"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the driver in
``kinds/`` and whose ``generator`` names the input generator in
``traffic/``), its limits (``limits/<workload>.json``) and its per-layer
metrics (``metrics/<metric>.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from portbench import tracing
from portbench.reference import kvzip as ref_kvzip
from portbench.reference.model import RefModel
from portbench.reference.prompts import SCORE_CHUNK, template
from portbench.roofline import peaks
from portbench.weights import make_weights

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "kvzip_tpu")
# a served token this many logit standard deviations below the reference's
# best is far off (``gap_share``): a token drawn at random from the
# vocabulary lies ~4.4 below the best of 152k
FAR = 3.0


def process_start() -> float:
    """This process's start on the wall clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A cell's files, its seed, the program's engine and the tracer."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device="cuda", dtype=torch.bfloat16, overrides: Optional[dict] = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}")
        self.spec = cells[workload]
        self.name, self.seed, self.seconds, self.trace = workload, int(seed), seconds, trace
        self.device, self.dtype = device, dtype
        conf = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = load_json(os.path.dirname(HERE), conf["file"])
        self.traffic = load_json(HERE, "traffic", self.spec["traffic"] + ".json")
        over = overrides or {}
        self.config = {**self.config, **over.get("config", {})}
        self.traffic = {**self.traffic, **over.get("traffic", {})}
        self.model, self.quant = self.config["model"], self.config["quant"]
        self.family = self.model["family"]
        self.sink_ids, _ = template(self.family)
        self.kind = importlib.import_module(f"portbench.kinds.{self.traffic['kind']}")
        gen = importlib.import_module(f"portbench.traffic.{self.traffic['generator']}")
        self.plan = gen.Plan(self.traffic, self.seed, self.model["vocab_size"])
        self.tracer = tracing.Tracer(trace, device)
        self.engine = None

    def build_engine(self, preset_config=None):
        """The program's engine over the benchmark's weights, with the
        configuration's keywords and the byte tokenizer."""
        from kvzip_tpu_torch.engine import Engine
        from kvzip_tpu_torch.tokenizer import ByteTokenizer

        for k, v in self.config.get("env", {}).items():
            os.environ[k] = v
        if torch.device(self.device).type == "cuda":
            from kvzip_tpu_torch import _build

            _build.build_all()  # every kernel library at once; a built one is reused
        tree = make_weights(self.model, self.seed, self.device, self.dtype)
        kw = dict(self.config.get("engine", {}))
        self.engine = Engine(self.config["preset"], config=preset_config, params=tree,
                             tokenizer=ByteTokenizer(self.model["vocab_size"]),
                             dtype=self.dtype, device=self.device, **kw)
        del tree


def per_layer_names(bench: dict, workload: str, reports: set) -> list:
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (workload in cells) if cells is not None else (m["moves"] in reports):
            out.append(m)
    return out


def end_to_end_names(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"]
            if m.get("workloads") is None or workload in m["workloads"]]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    v = sorted(values)
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ------------------------------------------------------------ comparison
def compare(cell: Cell, docs: list, controls: bool = False) -> dict:
    """The numbers compared with the reference over the sampled documents.

    The reference works out each document's KV again and the scores of
    ``score_chunks`` of its repeat chunks drawn from the seed; its decode
    check follows the program's kept rows (the stated threshold rule on the
    program's own scores), so that a score near the threshold, which
    rounding may move either way, changes no row of the comparison.

    ``gap``: the widest gap, over every served token of the sample, by
    which the token's reference logit lies below the reference's best (in
    units of that position's logit standard deviation); ``gap_mean`` its
    mean over the served tokens; ``gap_share`` the share of served tokens
    more than ``FAR`` below the best; ``score_err``: the relative RMS of
    the program's scores against the reference's over the scored chunks,
    ``score_err_l0`` the same in the first layer. With ``controls`` also
    the ``control_`` readings: the same of the control
    (``config["control"]``, the reference one precision step lower, its own
    scores, kept rows and decode), its tokens those it puts first.

    Each doc: {"ctx", "seqs", "first", "served", "score"} (the program's
    scores of the whole document, on the host)."""
    dev = cell.device
    weights = make_weights(cell.model, cell.seed, dev, cell.dtype)
    ratio, sink = cell.traffic["ratio"], len(cell.sink_ids)
    n_chunks = cell.traffic["score_chunks"]
    ctrl = {}
    if controls:
        ref = RefModel(cell.model, cell.quant, weights, cell.config["control"])
        for i, d in enumerate(docs):
            comp = ref_kvzip.compress(ref, cell.family, cell.sink_ids, d["ctx"], dev)
            keep = ref_kvzip.keep_rows(comp["score"], ratio, sink)
            logits = ref_kvzip.answer_logits(ref, comp, keep, d["seqs"], d["first"], dev)
            ctrl[i] = ([lg.argmax(dim=-1) for lg in logits], comp["score"].cpu(), keep)
            del comp, logits
        del ref
        _free()
    ref = RefModel(cell.model, cell.quant, weights, "f32")
    gaps, cgaps, every, c_every = [], [], [], []
    # a layer's squared error of the program's scores, of the control's; the reference's squared norm
    layer_err = torch.zeros((3, cell.model["num_hidden_layers"]), dtype=torch.float64)
    n_tok = 0
    for i, d in enumerate(docs):
        total = -(-len(d["ctx"]) // SCORE_CHUNK)
        rng = np.random.default_rng([cell.seed, 6, i])
        pick = sorted(int(c) for c in rng.permutation(total)[:n_chunks])
        comp = ref_kvzip.compress(ref, cell.family, cell.sink_ids, d["ctx"], dev, pick)
        keep = ref_kvzip.keep_rows(d["score"].to(dev), ratio, sink)
        logits = ref_kvzip.answer_logits(ref, comp, keep, d["seqs"], d["first"], dev)
        for lg, served in zip(logits, d["served"]):
            tok = torch.as_tensor(np.asarray(served, np.int64), device=dev)
            g = ref_kvzip.token_gaps(lg[:len(tok)], tok)
            gaps.append(g.max().item())
            every.append(g.cpu())
            n_tok += len(tok)
        cols = torch.cat([torch.arange(s, s + n) for s, n in comp["cols"]])
        s = comp["score"].cpu()[:, :, cols]
        layer_err[0] += ((d["score"][:, :, cols].float() - s) ** 2).sum(dim=(1, 2)).double()
        layer_err[2] += (s ** 2).sum(dim=(1, 2)).double()
        if controls:
            layer_err[1] += ((ctrl[i][1][:, :, cols] - s) ** 2).sum(dim=(1, 2)).double()
            c_logits = ref_kvzip.answer_logits(ref, comp, ctrl[i][2], d["seqs"], d["first"], dev)
            cg = [ref_kvzip.token_gaps(lg, ct) for lg, ct in zip(c_logits, ctrl[i][0])]
            cgaps += [g.max().item() for g in cg]
            c_every += [g.cpu() for g in cg]
            del c_logits
        del comp, logits
    every = torch.cat(every) if every else torch.zeros(0)
    out = {"gap": max(gaps) if gaps else float("nan"), "tokens": n_tok,
           "tokens_off_best": int((every > 0).sum()),
           "gap_mean": float(every.mean()) if every.numel() else float("nan"),
           "gap_share": float((every > FAR).double().mean()) if every.numel() else float("nan"),
           "requests": len(gaps), "docs": len(docs)}
    whole = (layer_err.sum(dim=1) / layer_err[2].sum()).sqrt()
    if layer_err[2].sum() > 0:
        rel = (layer_err / layer_err[2]).sqrt()
        out["score_err"] = float(whole[0])
        out["score_err_l0"] = float(rel[0, 0])
        out["score_err_layers"] = [round(float(v), 4) for v in rel[0]]
        if controls:
            out["control_score_err_l0"] = float(rel[1, 0])
            out["control_score_err_layers"] = [round(float(v), 4) for v in rel[1]]
    if controls:
        out["control_gap"] = max(cgaps) if cgaps else float("nan")
        c_every = torch.cat(c_every) if c_every else torch.zeros(0)
        out["control_gap_mean"] = float(c_every.mean()) if c_every.numel() else float("nan")
        out["control_gap_share"] = (float((c_every > FAR).double().mean()) if c_every.numel()
                                    else float("nan"))
        out["control_score_err"] = float(whole[1])
    del ref, weights
    _free()
    return out


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(cell: Cell, readings: dict, failed: int, limits: Optional[dict] = None) -> tuple:
    """(correct, checks): each number with a limit (``limits/<cell>.json``,
    or ``limits``) beside its limit."""
    if limits is None:
        path = os.path.join(HERE, "limits", cell.name + ".json")
        limits = load_json(path) if os.path.exists(path) else {}
    checks = {}
    ok = failed == 0 and bool(limits) and readings.get("requests", 0) > 0
    for name, lim in limits.items():
        v = readings.get(name, float("nan"))
        checks[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and math.isfinite(v) and v <= lim["limit"]
    if not limits:
        print(f"no limits for {cell.name} (limits/{cell.name}.json)", file=sys.stderr)
    return ok, checks


# ------------------------------------------------------------------ run
def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device="cuda", dtype=torch.bfloat16, overrides=None,
             controls: bool = False, preset_config=None) -> dict:
    """One run of a cell; returns the result dict (the last line's keys)
    and, under ``readings``, every number the comparison read."""
    cell = Cell(bench, workload, seed, seconds, trace, device, dtype, overrides)
    cell.build_engine(preset_config)
    cell.kind.setup(cell)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_process
    out = cell.kind.window(cell)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
                   "count": int(cell.spec["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        rec = out["record"]
        rec.update(model=cell.model, quant=cell.quant,
                   peaks=peaks(device_info["kind"]) or {}, kind=cell.traffic["kind"])
        reports = {m["name"] for m in end_to_end_names(bench, workload)}
        for m in per_layer_names(bench, workload, reports):
            mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                              "portbench_metric_" + m["name"].replace(".", "_"))
            v = mod.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        wins = tracing.windows(rec, "unit")
        device_info["busy_s"] = tracing.busy(rec, wins)
        device_info["window_s"] = tracing.length(wins)
        breakdown = tracing.breakdown(rec, wins)
        print(f"device {device_info['kind']}; power: {power_limit()}", file=sys.stderr)
    else:
        for m in end_to_end_names(bench, workload):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    for k, v in out.get("notes", {}).items():
        print(f"{k}: {v}", file=sys.stderr)
    docs = cell.kind.sample(cell, out)
    cell.engine = None
    out.pop("record", None)
    _free()
    t_ref = time.time()
    readings = compare(cell, docs, controls) if docs else {"requests": 0}
    readings["ref_s"] = time.time() - t_ref
    readings["setup_s"] = setup_s
    correct, checks = judge(cell, readings, out["failed"])
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["readings"] = readings
    return result
