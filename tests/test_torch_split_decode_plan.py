"""The launch plan of K4 and of K5's decode form
(``kvzip_tpu_torch/ops/ragged_decode.py``: ``plan_splits``, ``split_bounds``,
``merge_floats``), which mirrors ``csrc/split_decode.cuh``: the grid fits
the card at once (its merging CTAs wait for the others) or has one split,
a merging CTA's staging fits the shared memory the launcher checks, and
each kv head's S splits cover its live rows [0, min(base + T, C)) exactly
once, every split starting on a 16-key tile so that no tile straddles two
splits. The shapes are the smoke's (qwen2.5-7b's 4 kv heads x G 7 and
llama3.1-8b's 8 x 4 at T 1, 4 and 16 over 16,545 rows) and edges: one kv
head, G 32, a cache shorter than the splits, a live length that ends
within 16 rows of C."""

import pytest

from kvzip_tpu_torch.ops import ragged_decode
from test_torch_engine import one_torch_thread  # noqa: F401

SMS = 132  # the H100's SM count
ALIGN = ragged_decode.SPLIT_ALIGN

# (capacity, kv heads, G, T, base lengths)
SHAPES = {
    "qwen T 1": (19456, 4, 7, 1, [16544] * 4),
    "qwen T 4": (19456, 4, 7, 4, [16544, 9000, 19440, 0]),
    "qwen T 16": (19456, 4, 7, 16, [16544, 16543, 19440, 1]),
    "llama T 1": (19456, 8, 4, 1, [16544 - 977 * h for h in range(8)]),
    "llama T 16": (19456, 8, 4, 16, [16544 - 977 * h for h in range(8)]),
    "one kv head, G 32, T 16": (8192, 1, 32, 16, [8000]),
    "K4 T 8, G 7": (19456, 4, 7, 8, [16544] * 4),
    "short cache": (160, 4, 7, 3, [157, 140, 3, 100]),
    "odd capacity": (4099, 3, 7, 4, [4000, 17, 4095]),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_splits_fit_and_cover(name):
    C, Hkv, G, T, bases = SHAPES[name]
    rows = G * T
    S, groups = ragged_decode.plan_splits(C, Hkv, rows, SMS)
    assert S >= 1 and groups == -(-rows // ragged_decode.ROWS_PER_CTA)
    assert S == 1 or groups * S * Hkv <= SMS
    assert ragged_decode.merge_floats(rows, S) <= ragged_decode.MERGE_FLOATS
    assert S <= -(-C // 64)
    for base in bases:
        live = min(base + T, C)
        bounds = ragged_decode.split_bounds(live, S)
        assert len(bounds) == S
        covered = [k for k0, k1 in bounds for k in range(k0, k1)]
        assert covered == list(range(live))
        assert all(k0 % ALIGN == 0 or k0 == live for k0, _ in bounds)
        assert all(k1 % ALIGN == 0 or k1 == live for _, k1 in bounds)


def test_smoke_plans():
    """The smoke's decode shapes keep their PR 8 grids (K4 at T 1: 33
    splits of each of 4 heads) and K5's decode form fills the card at T 16
    (4 row groups of 32 rows, 8 splits)."""
    assert ragged_decode.plan_splits(19456, 4, 7, SMS) == (33, 1)
    assert ragged_decode.plan_splits(19456, 4, 56, SMS) == (16, 2)
    assert ragged_decode.plan_splits(19456, 4, 112, SMS) == (8, 4)


def test_merge_staging_caps_splits():
    """Where the card would allow more splits than a merging CTA can stage
    (one kv head, 32 rows a group: 132 splits need 80,256 floats), the plan
    takes the most that fit."""
    S, groups = ragged_decode.plan_splits(1 << 20, 1, 32, SMS)
    assert groups == 1 and 1 < S < SMS
    assert ragged_decode.merge_floats(32, S) <= ragged_decode.MERGE_FLOATS
    assert ragged_decode.merge_floats(32, S + 1) > ragged_decode.MERGE_FLOATS
