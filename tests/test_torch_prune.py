"""The port's keep masks against the reference's ``prune_mask`` on the same
scores: identical masks, ties included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import prune as jprune
from kvzip_tpu_torch import prune

from test_torch_engine import one_torch_thread  # noqa: F401


def _scores(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    shape = (4, 2, 300)
    if kind == "ties":          # a coarse grid: many equal scores
        return (rng.integers(0, 16, shape) / 16).astype(np.float32)
    if kind == "bf16":          # scores as the bf16 score hook produces them
        return np.array(jnp.asarray(rng.random(shape), jnp.bfloat16)
                        .astype(jnp.float32))
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["ties", "bf16", "continuous"])
@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.75])
@pytest.mark.parametrize("level,method", [("pair", "sort"),
                                          ("pair", "histogram"),
                                          ("pair-uniform", "sort")])
def test_keep_mask_matches_reference(kind, ratio, level, method):
    s = _scores(kind)
    want, w_thres, w_ratio = jprune.prune_mask(jnp.asarray(s), ratio, level,
                                               method=method)
    got, g_thres, g_ratio = prune.prune_mask(torch.from_numpy(s), ratio, level,
                                             method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert g_thres == w_thres
    assert g_ratio == w_ratio


def test_ratio_one_keeps_everything():
    s = torch.from_numpy(_scores("continuous"))
    for level in ("pair", "pair-uniform"):
        keep, _, r = prune.prune_mask(s, 1.0, level)
        assert keep.all() and r == 1.0
