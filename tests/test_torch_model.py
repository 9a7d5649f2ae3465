"""The port's decoder pieces and forward against the reference on the same
weights (``params_from_jax``) and token ids, in float32 on the CPU.

Tolerances: rope / rms_norm atol = rtol = 1e-5; logits atol = 1e-4 (two
frameworks' float32 matmuls over a few layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.cache import init_cache as j_init_cache
from kvzip_tpu.config import RopeConfig, tiny_config
from kvzip_tpu.models import params as jparams
from kvzip_tpu.models import rope as jrope
from kvzip_tpu.models.transformer import forward as j_forward
from kvzip_tpu.models.transformer import rms_norm as j_rms_norm
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch.cache import init_cache
from kvzip_tpu_torch.models import rope
from kvzip_tpu_torch.models.params import init_params, params_from_jax
from kvzip_tpu_torch.models.transformer import forward, rms_norm

from test_torch_engine import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _port_cfg(cfg):
    """The same config as the port's own dataclass."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["rope"] = tconfig.RopeConfig(**dataclasses.asdict(cfg.rope))
    return tconfig.ModelConfig(**fields)


def _jax_params(cfg, seed=0):
    """Reference weights as numpy, with random biases so the bias path is
    exercised (the reference initializes them to zero)."""
    tree = jax.device_get(jparams.init_params(cfg, jax.random.PRNGKey(seed),
                                              jnp.float32))
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):
        if b in tree["layers"]:
            tree["layers"][b] = rng.standard_normal(
                tree["layers"][b].shape).astype(np.float32) * 0.02
    return tree


@pytest.mark.parametrize("rope_cfg", [
    RopeConfig(theta=10000.0),
    RopeConfig(theta=500000.0, scaling_type="llama3", scaling_factor=8.0,
               original_max_position_embeddings=8192),
    RopeConfig(theta=1e6, scaling_type="yarn", scaling_factor=4.0,
               original_max_position_embeddings=32768),
])
def test_rope_matches_reference(rope_cfg):
    t_rope = tconfig.RopeConfig(**dataclasses.asdict(rope_cfg))
    np.testing.assert_array_equal(rope.inv_frequencies(t_rope, 128),
                                  jrope.inv_frequencies(rope_cfg, 128))
    pos = np.arange(3, 40, dtype=np.int32)
    x = np.random.default_rng(0).standard_normal((37, 4, 128)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(rope_cfg, 128, jnp.asarray(pos))
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    tc, ts = rope.rope_cos_sin(t_rope, 128, torch.from_numpy(pos))
    got = rope.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_jax_keeps_tree_and_values():
    cfg = tiny_config("qwen2")
    tree = _jax_params(cfg)
    got = params_from_jax(tree, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(got["layers"]["wq"].numpy(),
                                  tree["layers"]["wq"])
    np.testing.assert_array_equal(got["layers"]["bk"].numpy(),
                                  tree["layers"]["bk"])
    assert got["embed"].shape == tree["embed"].shape
    # the port's own seeded init has the reference's tree and shapes
    own = init_params(_port_cfg(cfg), torch.Generator().manual_seed(0),
                      "cpu", torch.float32)
    assert own.keys() == got.keys()
    assert {k: v.shape for k, v in own["layers"].items()} == \
        {k: v.shape for k, v in got["layers"].items()}


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_forward_logits_match_reference(family):
    cfg = tiny_config(family)
    tree = _jax_params(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree, device="cpu", dtype=torch.float32)
    pcfg = _port_cfg(cfg)
    C = 256
    jc = j_init_cache(cfg, C, jnp.float32)
    tc = init_cache(pcfg, C, torch.float32, "cpu")
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, 80)
    # a prefill chunk, a second chunk, then T <= 8 decode blocks
    for a, b in ((0, 64), (64, 72), (72, 75), (75, 76)):
        chunk = ids[a:b].astype(np.int32)
        res = j_forward(jp, cfg, jnp.asarray(chunk), jc, collect_logits="all",
                        attn_impl="dense")
        jc = res.cache
        got = forward(tp, pcfg, torch.from_numpy(chunk.astype(np.int64)), tc,
                      collect_logits="all")
        np.testing.assert_allclose(got.logits.numpy(), np.asarray(res.logits),
                                   atol=1e-4, rtol=0)
        assert tc.seen == int(jc.seen)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
