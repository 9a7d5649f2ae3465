"""The launch plan of K12 (``kvzip_tpu_torch/ops/w4a8_fused.py::plan``),
which mirrors ``csrc/w4a8_fused.cu``: each of the four products (o-proj,
gate/up, down, qkv) covers every (column block, input group) once, its
items are column blocks over contiguous runs of groups whose partials the
last of a block's items adds in split order, the grid stays within two
resident CTAs an SM with each CTA's quantized groups in the shared memory
the kernel reserves, and the units a CTA has asked for when it reaches a
product's barrier are that product's first units.
"""

import pytest

from kvzip_tpu_torch.ops import w4a8_fused
from test_torch_engine import one_torch_thread  # noqa: F401

SMS = 132  # the H100's SM count
GRID = 2 * SMS  # two CTAs an SM (csrc/w4a8_fused.cu OCC)

# (IN, OUT // 2) of o-proj, gate/up, down and qkv: qwen2.5-7b, the lane's
# small layer, and one with OUT/2 no multiple of the 128-column block
DIMS = {"qwen2.5-7b": ((3584, 1792), (3584, 18944), (18944, 1792), (3584, 2304)),
        "small": ((512, 256), (512, 1024), (1024, 256), (512, 384)),
        "ragged": ((384, 208), (256, 1168), (1168 // 16 * 128, 208), (256, 144))}


@pytest.mark.parametrize("name", sorted(DIMS))
@pytest.mark.parametrize("T", list(range(1, 9)))
def test_products_cover_each_unit_once(name, T):
    p = w4a8_fused.plan(T, DIMS[name], GRID)
    assert p["grid"] == GRID and p["xbuf"] <= w4a8_fused._XB_MAX
    runs = [w4a8_fused.cta_units(p, c) for c in range(GRID)]
    for k, pr in enumerate(p["products"]):
        assert 1 <= pr["S"] <= min(16, pr["G"], max(1, 2 * pr["G"] // T))
        units = [(cb, g) for run in runs for (kk, cb, g, _) in run if kk == k]
        assert sorted(units) == [(cb, g) for cb in range(pr["ncb"]) for g in range(pr["G"])]
        # an item: one column block over a contiguous run of groups, one
        # partial slot (split, column block); every split of a block exists
        items = {}
        for run in runs:
            for kk, cb, g, split in run:
                if kk == k:
                    items.setdefault((split, cb), []).append(g)
        assert len(items) == pr["n_items"]
        for (split, cb), gs in items.items():
            assert gs == list(range(split * pr["gps"], min(pr["G"], (split + 1) * pr["gps"])))
        for cb in range(pr["ncb"]):
            assert [s for s in range(pr["S"]) if (s, cb) in items] == list(range(pr["S"]))


@pytest.mark.parametrize("T", [1, 4, 8])
def test_items_taken_every_grid_th(T):
    """CTA c takes items c, c + grid, ... of each product, in that order,
    so the CTAs at work read the same input rows across the column blocks."""
    p = w4a8_fused.plan(T, DIMS["qwen2.5-7b"], GRID)
    for c in (0, 1, 100, GRID - 1):
        run = w4a8_fused.cta_units(p, c)
        for k, pr in enumerate(p["products"]):
            its = [split * pr["ncb"] + cb for kk, cb, _, split in run if kk == k]
            want = list(range(c, pr["n_items"], GRID))
            assert sorted(set(its), key=its.index) == want


@pytest.mark.parametrize("T", [1, 4, 8])
def test_prefetched_units_are_the_next_products_first(T):
    """Before each barrier a CTA has asked for exactly the first units of
    the next product in its stream, as many as the ring holds."""
    p = w4a8_fused.plan(T, DIMS["qwen2.5-7b"], GRID)
    for c in range(0, GRID, 7):
        run = w4a8_fused.cta_units(p, c)
        for k in range(1, 4):
            pre = w4a8_fused.prefetched(p, c, k)
            mine = [u for u in run if u[0] == k]
            assert pre == mine[:w4a8_fused._NS]
            assert len(pre) == min(w4a8_fused._NS, len(mine))
            if pre:  # the stream's next units after product k - 1's
                done = sum(1 for u in run if u[0] < k)
                assert run[done:done + len(pre)] == pre


def test_qwen_plan_fills_the_grid():
    """At T 1 every CTA has work and the busiest CTA stays within a few
    units of an even share."""
    p = w4a8_fused.plan(1, DIMS["qwen2.5-7b"], GRID)
    loads = [len(w4a8_fused.cta_units(p, c)) for c in range(GRID)]
    total = sum(pr["ncb"] * pr["G"] for pr in p["products"])
    assert sum(loads) == total and min(loads) > 0
    assert max(loads) <= total / GRID + 8
