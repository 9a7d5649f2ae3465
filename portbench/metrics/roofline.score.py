"""Kernels: the reconstruction scores (K2, ``score_kernel``) against their
bound (``roofline/attention.py::scores``), summed over the slice's
documents' scoring chunks, over the kernel's device time there, %."""

from portbench.roofline.work import ingest_unit
from portbench.tracing import op_time, windows

KERNELS = r"score_kernel"


def read(rec):
    t = op_time(rec, windows(rec, "unit"), KERNELS)
    if t <= 0 or not rec.get("peaks"):
        return None
    return 100.0 * sum(ingest_unit(rec, u)["score"] for u in rec["units"]) / t
