"""Spans and the device trace of a traced run (``--trace 1``).

The benchmark records spans from its own files, around its calls into the
program's layers (``Tracer.span``): on the card each span is a
``torch.profiler.record_function`` range, opened and closed after a
``torch.cuda.synchronize()`` where it is synced, so the work it launched
ran inside it. The profiler covers a steady slice of whole units
(documents or batches) and is reduced in memory to the spans and the
device operations (kernels, copies, fills) with their start and end on the
profiler's one clock; no trace file is written.

Per-layer metrics read the record this module builds (``record``):
``spans`` (name -> (start, end) ns), ``ops`` (name, start, end) on the
device, ``units`` (what the benchmark knows of each unit of the slice:
its shapes, its span names) and the cell's model, formats and peaks.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import sys
import time
from typing import Iterable, List, Optional, Tuple

import torch

PREFIX = "pb:"


class Tracer:
    """Spans around the program's layers and a profiler over a slice; off
    (every call a no-op) in an untraced run and outside the slice."""

    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.active = False
        self.prof = None
        self.spans: dict = {}
        self.ops: list = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = True):
        if not self.active:
            yield
            return
        if sync:
            self.sync()
        with torch.profiler.record_function(PREFIX + name):
            yield
            if sync:
                self.sync()

    def begin(self) -> None:
        if not self.on or self.active:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        self.prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                           with_stack=False, profile_memory=False)
        self.prof.__enter__()
        self.active = True

    def end(self) -> None:
        if not self.active:
            return
        self.sync()
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t1 = time.perf_counter()
        self.active = False
        self.spans, self.ops = _reduce(self.prof)
        self.prof = None
        print(f"profiler: stop {t1 - t0:.1f} s, reduce {time.perf_counter() - t1:.1f} s, "
              f"{len(self.ops)} device ops", file=sys.stderr, flush=True)


def _times(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        t0 = e.start_ns()
        return t0, t0 + e.duration_ns()
    t0 = int(e.start_us() * 1000)
    return t0, t0 + int(e.duration_us() * 1000)


def _reduce(prof) -> tuple:
    """The profiler's events as spans (our ``record_function`` ranges) and
    device operations."""
    spans, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(PREFIX):
            if not str(e.device_type()).endswith("CUDA"):  # its copy on the device's row is no op
                spans[name[len(PREFIX):]] = _times(e)
        elif str(e.device_type()).endswith("CUDA"):
            t0, t1 = _times(e)
            ops.append((name, t0, t1))
    ops.sort(key=lambda o: o[1])
    return spans, ops


# ----------------------------------------------------------- reductions
def windows(rec: dict, part: str) -> List[Tuple[int, int]]:
    """The (start, end) of span ``part`` of every unit of the slice that
    has it."""
    out = []
    for u in rec["units"]:
        name = u["spans"].get(part)
        if name in rec["spans"]:
            out.append(rec["spans"][name])
    return out


def replay_windows(rec: dict) -> List[Tuple[int, int]]:
    """Each batch's decode replays: from the end of its step's capture
    (which ends in a synchronize) to the batch's synced end."""
    out = []
    for u in rec["units"]:
        cap = rec["spans"].get(u["spans"].get("capture"))
        end = rec["spans"].get(u["spans"]["unit"])
        if cap and end:
            out.append((cap[1], end[1]))
    return out


def _inside(rec: dict, t0: int, t1: int) -> list:
    """The device operations that start in [t0, t1) (``ops`` is sorted by
    start)."""
    if "_starts" not in rec:
        rec["_starts"] = [a for _, a, _ in rec["ops"]]
    st = rec["_starts"]
    return rec["ops"][bisect.bisect_left(st, t0):bisect.bisect_left(st, t1)]


def op_time(rec: dict, wins: Iterable[Tuple[int, int]], pattern: Optional[str] = None) -> float:
    """Seconds of device operations (names matching ``pattern``) that start
    inside any of ``wins``."""
    rx = re.compile(pattern) if pattern else None
    hit: dict = {}
    total = 0
    for t0, t1 in wins:
        for name, a, b in _inside(rec, t0, t1):
            if rx is not None:
                if name not in hit:
                    hit[name] = rx.search(name) is not None
                if not hit[name]:
                    continue
            total += b - a
    return total / 1e9


def busy(rec: dict, wins: Iterable[Tuple[int, int]]) -> float:
    """Seconds in ``wins`` during which some device operation ran (the union
    of their intervals, each clipped to its window)."""
    total = 0
    for t0, t1 in wins:
        end = t0
        # an operation that started before the window may run into it
        for _, a, b in _inside(rec, t0 - 10 ** 9, t1):
            a, b = max(a, end), min(b, t1)
            if b > a:
                total += b - a
                end = b
    return total / 1e9


def length(wins: Iterable[Tuple[int, int]]) -> float:
    return sum(t1 - t0 for t0, t1 in wins) / 1e9


def breakdown(rec: dict, wins: List[Tuple[int, int]], n: int = 10) -> dict:
    """The device operations that took most time inside ``wins`` and the
    longest idle gaps there, each gap named by the innermost span around
    its start (what the host was doing)."""
    by_name: dict = {}
    gaps = []
    for t0, t1 in wins:
        end = t0
        for name, a, b in _inside(rec, t0 - 10 ** 9, t1):
            if a >= t0:
                by_name[name] = by_name.get(name, 0) + (b - a)
            if a > end:
                gaps.append((a - end, end))
            end = max(end, min(b, t1))
        if t1 > end:
            gaps.append((t1 - end, end))
    inner = sorted(rec["spans"].items(), key=lambda kv: kv[1][1] - kv[1][0])

    def label(t: int) -> str:
        for name, (a, b) in inner:
            if a <= t < b:
                return name.split(":", 1)[-1]
        return "outside any span"

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps.sort(reverse=True)
    return {"device_ops": [[name[:160], t / 1e9] for name, t in top],
            "idle_gaps": [[label(at), g / 1e9] for g, at in gaps[:n]]}
