"""``serving.py``: the host, merge and capture time a merged batch adds to
its decode steps. Over the traced run's batches after the profiled slice
(unprofiled, so the profiler's own host cost is not in it): each batch's
wall time minus its decode steps x ``step_device_ms``, summed and divided
by the number of batches (a mean, not a median)."""


def read(rec):
    post = rec.get("post_batches") or []
    if rec.get("step_ms") is None or not post:
        return None
    return sum(ms - steps * rec["step_ms"] for ms, steps in post) / len(post)
