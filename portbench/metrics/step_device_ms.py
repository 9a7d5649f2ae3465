"""Forward of the merged step (``models/`` through ``serving.py``'s captured
step): device ms of one replay of the slice's last batch's captured decode
step, over 20 replays between CUDA events, its answer ended."""


def read(rec):
    return rec.get("step_ms")
