"""``prune.py`` / ``pool.py`` / ``cache.py``: MiB of the merged batch's
cache tensors (pool rows, scales, tails, counters), from tensor sizes, a
mean over the slice's batches."""


def read(rec):
    sizes = [u["merged_bytes"] for u in rec["units"] if "merged_bytes" in u]
    return sum(sizes) / len(sizes) / 2 ** 20 if sizes else None
