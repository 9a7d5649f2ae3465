"""K2's launch plan (``kvzip_tpu_torch/ops/score_kernel.py``), which
mirrors ``csrc/score.cu``: the block size keeps a CTA's rows within its
shared memory and a TMA box, and the tiles a CTA visits give each visible
(query, key) pair of its block exactly once in the first pass, each window
column exactly once in the second, load no tile that no query of the
block sees, and leave unmasked only tiles that every query sees whole.
Visibility is held against a brute-force mask built as the reference
builds it (``attention.reconstruction_scores``)."""

import pytest
import torch

from kvzip_tpu_torch.ops import score_kernel
from test_torch_engine import one_torch_thread  # noqa: F401

SMS = 132  # the H100's SM count
TILE = score_kernel.KEY_TILE

# (sink, s_ctx, ctx_len, T, q_valid, G, kv heads)
SHAPES = {
    "qwen2.5-7b chunk": (160, 2048, 2000, 2304, 2060, 7, 4),
    "llama3.1-8b chunk": (160, 2048, 2000, 2304, 2060, 4, 8),
    "odd sink, short context": (37, 2048, 1000, 2304, 1777, 7, 4),
    "q_valid = T, full window": (37, 2048, 2048, 2304, 2304, 4, 8),
    "small chunk": (37, 256, 100, 320, 200, 7, 4),
    "no sink, one tile": (0, 128, 128, 128, 128, 1, 2),
    "G 32": (5, 300, 299, 400, 333, 32, 1),
}


def _visible(sink, s_ctx, ctx_len, T):
    """(T, K) bool: which keys each query sees, as the reference masks."""
    s0 = sink + s_ctx
    col = torch.arange(s0 + T)[None, :]
    row = torch.arange(T)[:, None]
    bad = ((col >= s0) & (col - s0 > row)) | ((col >= sink + ctx_len) & (col < s0))
    return ~bad


def _tile_mask(kind, col0, ctx_len, sink, s_ctx, rows, K):
    """The kernel's own visibility inside one tile: (rows, TILE) bool over
    key columns col0 .. col0 + TILE - 1 (columns past K never visible)."""
    cols = col0 + torch.arange(TILE)[None, :]
    r = rows[:, None]
    s0 = sink + s_ctx
    if kind == "a":
        vis = cols < sink + ctx_len
    elif kind == "rep":
        vis = cols - s0 <= r
    else:
        vis = cols - sink < ctx_len
    return vis & (cols < K) & torch.ones_like(r, dtype=torch.bool)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_fits(name):
    sink, s_ctx, ctx_len, T, q_valid, G, Hkv = SHAPES[name]
    nq = score_kernel.plan(G, Hkv, q_valid, SMS)
    assert 1 <= nq <= min(256, q_valid) and nq * G <= score_kernel.MAX_ROWS
    if name == "qwen2.5-7b chunk":  # two waves of two row tiles a consumer warpgroup
        assert -(-Hkv * -(-q_valid // nq) // SMS) == 2 and -(-nq * G // 64) == 4


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tiles_cover_visible_pairs_once(name):
    sink, s_ctx, ctx_len, T, q_valid, G, Hkv = SHAPES[name]
    s0, K = sink + s_ctx, sink + s_ctx + T
    vis = _visible(sink, s_ctx, ctx_len, T)
    nq = score_kernel.plan(G, Hkv, q_valid, SMS)
    n_blocks = -(-q_valid // nq)
    for b in range(n_blocks):
        q0, q_end = b * nq, min(b * nq + nq, q_valid, T)
        rows = torch.arange(q0, q_end)
        tiles = score_kernel.tile_plan(sink, s_ctx, ctx_len, q0, q_end)
        seen = torch.zeros(len(rows), K, dtype=torch.int32)
        window = torch.zeros(s_ctx, dtype=torch.int32)
        n_a = -(-(sink + ctx_len) // TILE)
        for i, (pas, col0, masked) in enumerate(tiles):
            kind = "w" if pas == 2 else "a" if i < n_a else "rep"
            m = _tile_mask(kind, col0, ctx_len, sink, s_ctx, rows, K)
            assert m.any(), (name, b, i)  # a tile no query sees is never loaded
            if not masked:
                assert m.all(), (name, b, i)
            lo, hi = col0, min(col0 + TILE, K)
            if pas == 1:
                seen[:, lo:hi] += m[:, :hi - lo].int()
            else:
                window[lo - sink:min(hi - sink, s_ctx)] += m[0, :min(hi, sink + s_ctx) - lo].int()
        assert torch.equal(seen, vis[q0:q_end].int()), (name, b)
        assert torch.equal(window, (torch.arange(s_ctx) < ctx_len).int()), (name, b)
        assert [p for p, _, _ in tiles] == sorted(p for p, _, _ in tiles)
