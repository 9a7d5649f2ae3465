"""``prune.py`` / ``pool.py`` / ``cache.py``: the synced host span around
``Engine.prune(state, ratio, level)`` (threshold, mask, pool build), ms a
document, a mean over the slice."""

from portbench.tracing import length, windows


def read(rec):
    wins = windows(rec, "prune")
    return length(wins) * 1e3 / len(wins) if wins else None
