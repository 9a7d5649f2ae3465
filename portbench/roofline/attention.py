"""Operations and bytes of the attention work, per layer: the context
attention of prefill and of the scoring forwards (K1 in bf16; K5's
prefill form and K6 over int4 rows), the reconstruction scores (K2), and
decode attention over a pool (K3 over bf16 rows, K7 over int4 rows).

Conventions (those of the port's kernel table): a visible (query, key)
pair costs 4 D operations a query head in attention (q.k and p.v) and
2 D in the scores (q.k once); q, the output and each key and value row
are read or written once; a bf16 row of D elements is 2 D bytes, an int4
row D / 2 bytes plus its scale and zero (8 bytes as the pool stores them,
4 in the dense cache's bf16).
"""

from __future__ import annotations


def row_bytes(D: int, int4: bool, pool: bool = False) -> int:
    """Bytes of one K (or V) row of one kv head."""
    if not int4:
        return 2 * D
    return D // 2 + (8 if pool else 4)


def causal(H: int, Hkv: int, D: int, T: int, base: int, int4: bool) -> tuple:
    """T queries after ``base`` cached rows, causal among themselves: query
    t sees base + t + 1 keys. Returns (operations, bytes)."""
    pairs = H * (T * base + T * (T + 1) // 2)
    S = base + T
    return 4 * D * pairs, 2 * (2 * T * H * D) + 2 * Hkv * S * row_bytes(D, int4)


def scores(H: int, Hkv: int, D: int, n_q: int, sink: int, n: int) -> tuple:
    """K2 over one scoring chunk: ``n_q`` valid repeat queries against the
    sink, the chunk's ``n`` rows and themselves (causal); the scores of the
    chunk's rows written once (float32)."""
    pairs = H * (n_q * (sink + n) + n_q * (n_q + 1) // 2)
    return 2 * D * pairs, 2 * (n_q * H * D + Hkv * (sink + n + n_q) * D) + 4 * Hkv * n


def pool_decode(H: int, Hkv: int, D: int, T: int, live: int, tails: list, int4: bool) -> tuple:
    """T new rows of each of ``len(tails)`` sequences over a (merged) pool of
    ``live`` context rows (every kv head's, summed) and each sequence's
    tail of ``tails[b]`` rows before this call. Returns (operations,
    bytes)."""
    G = H // Hkv
    n_seq = len(tails)
    keys = live + Hkv * sum(t + T for t in tails)
    tail_rows = Hkv * sum(t + T for t in tails)
    nbytes = live * 2 * row_bytes(D, int4, pool=True) + 2 * 2 * tail_rows * D \
        + 2 * 2 * T * n_seq * H * D
    return 4 * D * G * T * keys, nbytes
