"""The yardstick of the per-layer metrics: the published peaks of a card
(``peaks.json``) and, one file per kernel family, the operations and bytes
a piece of work needs, counted from its shapes. Bounds count each input
byte read once and each output byte written once, and only the (query,
key) pairs a mask leaves visible, so a bound never exceeds the time any
kernel can take."""

from __future__ import annotations

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name``); a card not in the table has none."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        table = json.load(f)
    return table.get(kind)


def bound_s(flops: float, nbytes: float, peak_ops: float, bw: float) -> float:
    """The least time of a piece of work: the larger of its operations over
    the peak and its bytes over the bandwidth."""
    return max(flops / peak_ops, nbytes / bw)
