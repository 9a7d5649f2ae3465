"""Phase timers + device memory reporting (reference `utils/func.py:42-79`):
a card in use is synchronized before each stamp and its allocated memory
reported; optional ``torch.profiler`` trace capture."""

from __future__ import annotations

import contextlib
import os
from time import time

import torch


def _card_in_use() -> bool:
    """Whether this process has used the card (a CPU run never starts
    CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_mem_gb() -> tuple:
    """(allocated GB, total GB) of the current card; (0, 0) on the CPU."""
    if not _card_in_use():
        return 0.0, 0.0
    total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    return torch.cuda.memory_allocated() / 1024 ** 3, total / 1024 ** 3


def sync():
    """Wait for the card's queued work (nothing on the CPU)."""
    if _card_in_use():
        torch.cuda.synchronize()


class TimeStamp:
    """Phase timer: `tt = TimeStamp(); ...; tt("phase", denominator=n)`."""

    def __init__(self, verbose: bool = True, precision: int = 1,
                 unit: str = "s"):
        self.verbose = verbose
        self.precision = precision
        self.unit = unit
        self.set()

    def set(self):
        if self.verbose:
            sync()
            self.start = time()

    def elapsed(self, denominator: float = 1.0) -> float:
        val = time() - self.start
        if self.unit == "ms":
            val *= 1000
        return round(val / denominator, self.precision)

    def __call__(self, msg: str = "", denominator: float = 1.0):
        if self.verbose:
            sync()
            alloc, limit = device_mem_gb()
            tt = self.elapsed(denominator)
            print(f"## Time: {tt}{self.unit}. Mem: {alloc:.2f}/{limit:.2f} GB."
                  f" [{msg}]", flush=True)
            self.set()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` trace around a region, the card's kernels too
    where one is in use, written to ``<logdir>/trace.json`` (Chrome trace
    format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
