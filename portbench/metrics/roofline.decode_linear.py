"""Kernels: the decode steps' linears and head (cuBLAS GEMMs in bf16; K8,
``w4a8_kernel`` and its ``act_quant_kernel``, in W4A8; the int8 head's
GEMM) in the steps' replays, against the bound of every step's weights
and activations (``roofline/linear.py::step_bound``), %."""

from portbench.roofline.work import serve_unit
from portbench.tracing import op_time, replay_windows

KERNELS = r"gemm|Gemm|nvjet|cutlass|xmma|splitKreduce|gemv|w4a8_kernel|act_quant_kernel"


def read(rec):
    t = op_time(rec, replay_windows(rec), KERNELS)
    if t <= 0 or not rec.get("peaks"):
        return None
    return 100.0 * sum(serve_unit(rec, u)["decode_linear"] for u in rec["units"]) / t
