"""The device: the share of the slice's units (documents or batches, their
synced spans) in which no device operation ran, %."""

from portbench.tracing import busy, length, windows


def read(rec):
    wins = windows(rec, "unit")
    span = length(wins)
    return 100.0 * (1.0 - busy(rec, wins) / span) if span > 0 and rec["ops"] else None
