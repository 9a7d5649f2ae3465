"""The whole step of ``serve``: the model's operations over the slice's
batches (query ingest and decode through the merged pool;
``roofline/work.py``) at the peak of the precision each part's matmuls run
in, over the slice's seconds, %."""

from portbench.roofline.work import serve_unit
from portbench.tracing import length, windows


def read(rec):
    wins = windows(rec, "unit")
    if not wins or not rec.get("peaks"):
        return None
    return 100.0 * sum(serve_unit(rec, u)["model"] for u in rec["units"]) / length(wins)
