"""Kernels: context attention (prefill and the scoring forwards) against
its bound. K1 (``flash_bf16_kernel``) over bf16 rows; K5's prefill form
and K6 (``flash_int4_wgmma_kernel``) over int4 rows. The sum of the
bounds (``roofline/attention.py::causal``) over the device time of those
kernels in the slice's documents, %."""

from portbench.roofline.work import ingest_unit
from portbench.tracing import op_time, windows

KERNELS = r"flash_bf16_kernel|flash_int4_wgmma_kernel"


def read(rec):
    t = op_time(rec, windows(rec, "unit"), KERNELS)
    if t <= 0 or not rec.get("peaks"):
        return None
    return 100.0 * sum(ingest_unit(rec, u)["ctx_attn"] for u in rec["units"]) / t
