"""The qwen3 and gemma3 decoder pieces of the port against the JAX package,
in float32 on the CPU, from the same weights (``params_from_jax``) and
token ids.

Every norm weight (``ln_attn``, ``ln_mlp``, ``q_norm``, ``k_norm``,
``ln_post_attn``, ``ln_post_mlp``, ``final_norm``) is drawn from a numpy
seed: the reference's init gives ones, and with unit weights a norm
applied to the wrong layer or tensor would not show.

- The forward of ``tiny_config("qwen3")`` (qk-norm) and the plain forward
  of ``tiny_config("gemma3")`` over a dense cache (gemma norms, embedding
  scale, post-norms, gelu, local rope and the sliding window on every other
  layer), a prefill chunk, a second chunk and two short blocks: logits
  within 1e-4 (two frameworks' float32 matmuls over a few layers).
- gemma3 with W8A8 weights and the fused activation quantization (K13's
  and K14's plain versions in their gemma and gelu modes against the
  reference's Pallas kernels in interpret mode): the two frameworks' last
  bits may move an int8 value on a rounding boundary one step, so the
  logits are held within 1e-2 of their largest magnitude.
- A tiny qwen3 ``Engine`` (head_dim 128, so both build the pool) through
  prefill, scoring, a pair prune and two answers: scores within 1e-5, keep
  masks equal away from the threshold, greedy tokens equal.
- qwen3 with W4A8 weights and the fused decode layer (K12's plain version,
  qk-norm applied to its fused qkv): from the reference's scored int4
  state, the port's fused tokens equal its composed ones and the
  reference's composed ones.
- ``params_from_jax`` carries a qwen3 and a gemma3 tree leaf for leaf,
  with the keys of the port's own init.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import prune as jprune
from kvzip_tpu.cache import init_cache as j_init_cache
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.models.transformer import forward as j_forward
from kvzip_tpu.ops import quant as jquant
from kvzip_tpu_torch import prune
from kvzip_tpu_torch.cache import init_cache
from kvzip_tpu_torch.engine import Engine, KVState
from kvzip_tpu_torch.models import transformer
from kvzip_tpu_torch.models.params import init_params, params_from_jax

from test_torch_engine import CTX, QUERY, IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_engine_quant import QUANT, QUERY_Q, _carry_dense
from test_torch_model import _port_cfg

NORMS = ("ln_attn", "ln_mlp", "q_norm", "k_norm", "ln_post_attn", "ln_post_mlp")


def seeded_tree(cfg, seed=0, scale=1.0):
    """The reference's init as numpy, the projections times ``scale``, every
    norm weight drawn from the seed (gemma's around 0, since it multiplies
    by 1 + w; the others around 1)."""
    tree = jax.device_get(jparams.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    base = 0.0 if cfg.gemma_style_norm else 1.0
    lp = tree["layers"]
    for n in lp:
        if n in NORMS:
            lp[n] = (base + 0.5 * rng.standard_normal(lp[n].shape)).astype(np.float32)
        elif n in jparams._BIG_SLOTS:
            lp[n] = lp[n] * np.float32(scale)
    tree["final_norm"] = (base + 0.5 * rng.standard_normal(tree["final_norm"].shape)
                          ).astype(np.float32)
    return tree


def _hold_forward(cfg, tree, impl, atol, rel=False):
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree, device="cpu", dtype=torch.float32)
    pcfg = _port_cfg(cfg)
    jc = j_init_cache(cfg, 256, jnp.float32)
    tc = init_cache(pcfg, 256, torch.float32, "cpu")
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, 80)
    # a prefill chunk, a second chunk, then two short blocks
    for a, b in ((0, 64), (64, 72), (72, 75), (75, 76)):
        chunk = ids[a:b].astype(np.int32)
        res = j_forward(jp, cfg, jnp.asarray(chunk), jc, collect_logits="all",
                        attn_impl="dense")
        jc = res.cache
        got = transformer.forward(tp, pcfg, torch.from_numpy(chunk.astype(np.int64)), tc,
                                  collect_logits="all", attn_impl=impl).logits.numpy()
        want = np.asarray(res.logits)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=atol * (np.abs(want).max() if rel else 1.0))
        assert tc.seen == int(jc.seen)


@pytest.mark.parametrize("family,impl", [("qwen3", "flash"), ("gemma3", "dense"),
                                         ("gemma3", "blockwise")])
def test_forward_logits_match_reference(family, impl):
    cfg = tiny_config(family)
    _hold_forward(cfg, seeded_tree(cfg), impl, 1e-4)


def test_gemma3_w8a8_fused_act_matches_reference():
    cfg = dataclasses.replace(tiny_config("gemma3", num_layers=2), fused_act=True)
    tree = seeded_tree(cfg)
    tree = jax.device_get(jquant.quantize_params_w8a8(jax.tree_util.tree_map(jnp.asarray,
                                                                             tree)))
    calls = []
    real = transformer.silu_mul_quant
    transformer.silu_mul_quant = lambda *a, **kw: calls.append(kw["act"]) or real(*a, **kw)
    try:
        _hold_forward(cfg, tree, "dense", 1e-2, rel=True)
    finally:
        transformer.silu_mul_quant = real
    assert calls and set(calls) == {"gelu_pytorch_tanh"}


def test_gemma3_forward_refuses_the_kernels():
    cfg = _port_cfg(tiny_config("gemma3"))
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    with pytest.raises(ValueError, match="sliding window"):
        transformer.forward(tp, cfg, torch.zeros(4, dtype=torch.int64),
                            init_cache(cfg, 64, torch.float32, "cpu"))


@pytest.mark.parametrize("family", ["qwen3", "gemma3"])
def test_params_from_jax_carries_family_norms(family):
    cfg = tiny_config(family)
    tree = seeded_tree(cfg)
    got = params_from_jax(tree, device="cpu", dtype=torch.float32)
    for n in NORMS:
        if n in tree["layers"]:
            np.testing.assert_array_equal(got["layers"][n].numpy(), tree["layers"][n])
    want = {"qwen3": {"q_norm", "k_norm"},
            "gemma3": {"q_norm", "k_norm", "ln_post_attn", "ln_post_mlp"}}[family]
    assert want <= set(got["layers"])
    own = init_params(_port_cfg(cfg), torch.Generator().manual_seed(0), "cpu", torch.float32)
    assert {k: v.shape for k, v in own["layers"].items()} == \
        {k: v.shape for k, v in got["layers"].items()}
    assert own["layers"]["q_norm"].shape == (cfg.num_layers, cfg.head_dim)


# ------------------------------------------------------------ the engines
SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128)


@pytest.fixture(scope="module")
def qwen3_engines():
    jcfg = tiny_config("qwen3", **SHAPE)
    tree = seeded_tree(jcfg, scale=7.0)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), max_new_tokens=8,
              decode_budget=136, capacity_granularity=256, score_chunk_size=256)
    jeng = JEngine("tiny-qwen3", config=jcfg,
                   params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    teng = Engine("tiny-qwen3", config=_port_cfg(jcfg),
                  params=params_from_jax(tree, "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    return jeng, teng


def test_qwen3_engine_matches_reference(qwen3_engines):
    jeng, teng = qwen3_engines
    jst = jeng.prefill(CTX[:700], prefill_chunk_size=256)
    tst = teng.prefill(CTX[:700], prefill_chunk_size=256)
    j_score, t_score = np.asarray(jst.score), tst.score.numpy()
    np.testing.assert_allclose(t_score, j_score, rtol=1e-5, atol=1e-5)
    j_keep, thres, _ = jprune.prune_mask(jnp.asarray(j_score), 0.3, "pair",
                                         method="histogram")
    t_keep = prune.prune_mask(tst.score, 0.3, "pair", method="histogram")[0]
    far = np.abs(j_score - thres) > 1e-6
    np.testing.assert_array_equal(t_keep.numpy()[far], np.asarray(j_keep)[far])
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    assert type(tst.cache).__name__ == "PoolKV"
    for _ in range(2):
        assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)


def test_qwen3_w4a8_fused_layer_matches_composed(monkeypatch):
    """K12's plain version with qk-norm on its fused qkv: from the
    reference's scored int4 state, the port's fused tokens equal its
    composed ones and the reference's composed ones."""
    shape = dict(SHAPE, num_layers=2)
    jcfg = tiny_config("qwen3", **shape)
    tree = seeded_tree(jcfg, scale=7.0)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), max_new_tokens=4, decode_budget=132,
              capacity_granularity=256, score_chunk_size=256, **QUANT)
    jeng = JEngine("tiny-qwen3", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    teng = Engine("tiny-qwen3", config=_port_cfg(jcfg),
                  params=params_from_jax(jax.device_get(jeng.params), "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    jst = jeng.prefill(CTX[:700], prefill_chunk_size=256)
    tst = KVState(cache=_carry_dense(jst.cache), kv_type="evict", sink=jst.sink,
                  ctx_len=jst.ctx_len, prefill_len=jst.prefill_len,
                  score=torch.from_numpy(np.array(jst.score)))
    tst.snapshot()
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    calls = []
    real = transformer.w4a8_layer_fused
    monkeypatch.setattr(transformer, "w4a8_layer_fused",
                        lambda *a, **k: calls.append(a[8]) or real(*a, **k))
    composed = jeng.generate(QUERY_Q, jst)
    teng.fuse_layer = "on"
    assert teng.generate(QUERY_Q, copy.deepcopy(tst)) == composed
    assert len(calls) >= 2 * shape["num_layers"]
    teng.fuse_layer = "off"
    assert teng.generate(QUERY_Q, tst) == composed
