"""The port's W8A8 engine (QServe's W8A8-KV4 geometry,
``Engine(weight_quant="w8a8")``) against the reference engine: with a
bf16-style or an int4 KV cache, with the activation quantization as
separate ops or fused (K13/K14's plain versions), and once with windowed
scoring (K9's plain version). Both get the same tiny qwen2 config (qkv
bias, so the int8 products' bias path runs) and the same prepared
parameters (quantized by the reference, carried across by
``params_from_jax``), in float32 on the CPU. The reference runs with
``flat_decode="on"`` so that it, like the port, builds the pool on the CPU.

As for the W4A8 path (``tests/test_torch_engine_quant.py``): the two
frameworks sum float32 products in different orders, so an activation
lying within those last bits of an int8 rounding boundary rounds the other
way on one side, and the step (1/127 of the token's largest activation)
carries through the later layers. So, from the same tokens, the scores are
held statistically: correlation with the reference's at least 0.98 and
pair keep masks at ratio 0.3 agreeing on at least 95% of the entries. From
one state (the reference's dense cache and scores, carried across) the keep
masks and the greedy tokens before and after the prune are held exactly;
windowed scoring changes nothing of that, so it is held from the same
tokens only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import prune as jprune
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch import prune
from kvzip_tpu_torch.cache import Int4KVCache, KVCache
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.models.params import params_from_jax

from test_torch_engine import CTX, IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_engine_quant import QUERY_Q, _carry_dense

CTX_Q = CTX[:700]
SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2)


@pytest.fixture(scope="module")
def tree():
    jcfg = tiny_config("qwen2", **SHAPE)
    t = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    # weights at 7x the init scale, as in test_torch_engine.py
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        t["layers"][name] = t["layers"][name] * np.float32(7.0)
    return t


def _run(tree, kv_quant, act_fused, scoring_attend="full"):
    """Both engines, prefilled and scored on CTX_Q in 256-row chunks."""
    jcfg = tiny_config("qwen2", **SHAPE)
    tcfg = tconfig.tiny_config("qwen2", **SHAPE)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), max_new_tokens=4,
              decode_budget=132, capacity_granularity=256, score_chunk_size=256,
              weight_quant="w8a8", kv_quant=kv_quant, act_fused=act_fused,
              scoring_attend=scoring_attend)
    jeng = JEngine("tiny-qwen2", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    teng = Engine("tiny-qwen2", config=tcfg,
                  params=params_from_jax(jax.device_get(jeng.params), "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    assert teng.config.fused_act == (act_fused == "pallas") == jeng.config.fused_act
    return (jeng, teng, jeng.prefill(CTX_Q, prefill_chunk_size=256),
            teng.prefill(CTX_Q, prefill_chunk_size=256))


@pytest.fixture(scope="module", params=[("none", "xla"), ("none", "pallas"),
                                        ("int4", "xla"), ("int4", "pallas")],
                ids=lambda p: f"kv-{p[0]}-act-{p[1]}")
def run(request, tree):
    return _run(tree, *request.param)


def _hold_scores(run):
    jeng, teng, jst, tst = run
    assert isinstance(tst.cache, Int4KVCache if teng.kv_quant == "int4" else KVCache)
    np.testing.assert_array_equal(tst.cache.lengths.numpy(), np.asarray(jst.cache.lengths))
    j_score, t_score = np.asarray(jst.score), tst.score.numpy()
    assert np.isfinite(t_score).all()
    corr = np.corrcoef(t_score.ravel(), j_score.ravel())[0, 1]
    keep = prune.prune_mask(tst.score, 0.3, "pair", method="histogram")[0].numpy()
    j_keep = np.asarray(jprune.prune_mask(jnp.asarray(j_score), 0.3, "pair",
                                          method="histogram")[0])
    agree = (keep == j_keep).mean()
    assert corr >= 0.98 and agree >= 0.95, (corr, agree)


def test_w8a8_scores_from_the_same_tokens_within_rounding_noise(run):
    _hold_scores(run)


def test_w8a8_windowed_scores_from_the_same_tokens_within_rounding_noise(tree):
    """Windowed scoring on the fused W8A8-KV4 engine. Only the scoring pass
    differs from the full-scoring engine, so the one-state holds below
    cover the rest."""
    _hold_scores(_run(tree, "int4", "pallas", "window"))


def _carry(jst, tst):
    """The port's state with the reference's dense cache and scores."""
    jc = jst.cache
    if isinstance(tst.cache, Int4KVCache):
        cache = _carry_dense(jc)
    else:
        cache = KVCache(k=torch.from_numpy(np.array(jc.k)), v=torch.from_numpy(np.array(jc.v)),
                        lengths=torch.from_numpy(np.array(jc.lengths)), seen=int(jc.seen))
    st = dataclasses.replace(tst, cache=cache, score=torch.from_numpy(np.array(jst.score)))
    st.snapshot()
    return st


def test_w8a8_masks_and_greedy_tokens_from_one_state_match_reference(run):
    jeng, teng, jst, tst = run
    tst = _carry(jst, tst)
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
    keep = prune.prune_mask(tst.score, 0.3, "pair", method="histogram")[0].numpy()
    j_keep = np.asarray(jprune.prune_mask(jst.score, 0.3, "pair", method="histogram")[0])
    np.testing.assert_array_equal(keep, j_keep)
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    np.testing.assert_array_equal(tst.cache.lengths.numpy(), np.asarray(jst.cache.lengths))
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
