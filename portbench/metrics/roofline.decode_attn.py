"""Kernels: decode attention over the merged pool (K3 over bf16 rows, K7
over int4 rows: ``int4_decode_kernel``; ``split_decode_kernel`` where a
dense cache is decoded) in the decode steps' replays (after the step's
capture to the batch's end), against the bound of every step's
attention (``roofline/attention.py::pool_decode``), %."""

from portbench.roofline.work import serve_unit
from portbench.tracing import op_time, replay_windows

KERNELS = r"int4_decode_kernel|split_decode_kernel"


def read(rec):
    t = op_time(rec, replay_windows(rec), KERNELS)
    if t <= 0 or not rec.get("peaks"):
        return None
    return 100.0 * sum(serve_unit(rec, u)["decode_attn"] for u in rec["units"]) / t
