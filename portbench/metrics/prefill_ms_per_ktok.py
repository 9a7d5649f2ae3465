"""``engine.py``: the synced host span around ``Engine.prefill(ids, do_score=False)``,
summed over the slice's documents, ms a thousand context tokens."""

from portbench.tracing import length, windows


def read(rec):
    wins = windows(rec, "prefill")
    ctx = sum(u["ctx"] for u in rec["units"])
    return length(wins) * 1e3 / (ctx / 1e3) if wins and ctx else None
