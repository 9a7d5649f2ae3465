"""Windowed scoring (``Engine(scoring_attend="window")``) of the port against
the reference, on the CPU in float32:

- the plain version of K9 against the reference's Pallas kernel in
  interpret mode and against its ``windowed_scoring_attend``, at a few
  (ctx_len, sink), a short last window among them: atol = rtol = 1e-5
  (float32 on both sides; only the summation order differs);
- the port alone: when one window covers the context, windowed scoring is
  exact scoring (scores atol 3e-4, as in ``tests/test_scoring_window.py``;
  greedy tokens after the prune equal), for a bf16-style and an int4 cache;
- a multi-window run against ``kvzip_tpu.Engine(scoring_attend="window")``
  on carried weights: scores atol = rtol = 1e-5, keep masks identical
  except within 1e-6 of the threshold, greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import prune as jprune
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.ops import attention as jattention
from kvzip_tpu.ops import windowed_attend as jwindowed
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch import prune
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.ops import attention, windowed_attend

from test_torch_engine import IdTokenizer, one_torch_thread  # noqa: F401

CTX_SHORT = "The survey ship Halcyon logged anomaly 4417 near the trench. " * 6
CTX_LONG = "Sector logs mention the frigate Peregrine and beacon 7731. " * 14
QUERY = "Which beacon is?"  # 16 tokens: one query chunk shape to compile
SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2)


@pytest.mark.parametrize("ctx_len,sink", [(256, 37), (100, 37), (200, 5)])
def test_windowed_attend_plain_matches_reference(ctx_len, sink):
    T, H, Hkv, D, s_ctx = 96, 8, 2, 128, 256
    r = np.random.default_rng(ctx_len + sink)
    q = r.standard_normal((T, H, D)).astype(np.float32)
    keys = r.standard_normal((Hkv, sink + s_ctx + T, D)).astype(np.float32)
    vals = r.standard_normal((Hkv, sink + s_ctx + T, D)).astype(np.float32)
    kw = dict(sink=sink, s_ctx=s_ctx, scale=D ** -0.5)
    want = np.asarray(jwindowed.windowed_attend(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(vals), ctx_len, **kw,
        interpret=True))
    got = windowed_attend.windowed_attend(torch.from_numpy(q), torch.from_numpy(keys),
                                          torch.from_numpy(vals), ctx_len, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    s0 = sink + s_ctx
    parts = [keys[:, :sink], keys[:, sink:s0], np.swapaxes(keys[:, s0:], 0, 1),
             vals[:, :sink], vals[:, sink:s0], np.swapaxes(vals[:, s0:], 0, 1)]
    want = np.asarray(jattention.windowed_scoring_attend(
        jnp.asarray(q), *map(jnp.asarray, parts), ctx_len, scale=D ** -0.5,
        out_dtype=jnp.float32))
    got = windowed_attend.windowed_scoring_attend_fused(
        torch.from_numpy(q), *map(torch.from_numpy, parts), ctx_len, scale=D ** -0.5,
        out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got2 = attention.windowed_scoring_attend(
        torch.from_numpy(q), *map(torch.from_numpy, parts), ctx_len, scale=D ** -0.5,
        out_dtype=torch.float32)
    assert torch.equal(got, got2)


def _engine(scoring_attend, kv_quant="none", params=None, seed=5):
    cfg = tconfig.tiny_config("llama", **SHAPE)
    return Engine("tiny-llama", config=cfg, params=params,
                  tokenizer=IdTokenizer(cfg.vocab_size), dtype=torch.float32,
                  device="cpu", max_new_tokens=6, decode_budget=256,
                  capacity_granularity=256, score_chunk_size=512, kv_quant=kv_quant,
                  scoring_attend=scoring_attend, seed=seed)


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_window_equals_full_when_window_covers_context(kv_quant):
    eng_f = _engine("full", kv_quant)
    st_f = eng_f.prefill(CTX_SHORT, prefill_chunk_size=256)
    assert st_f.ctx_len <= 512, "context must fit one scoring window"
    eng_w = _engine("window", kv_quant, params=eng_f.params)
    st_w = eng_w.prefill(CTX_SHORT, prefill_chunk_size=256)
    np.testing.assert_allclose(st_w.score.numpy(), st_f.score.numpy(), rtol=0, atol=3e-4)

    q = eng_f.apply_template("What anomaly number was logged?")
    eng_f.prune(st_f, 0.5, "pair")
    eng_w.prune(st_w, 0.5, "pair")
    assert eng_w.generate(q, st_w) == eng_f.generate(q, st_f)


def test_window_multi_chunk_matches_reference():
    jcfg = tiny_config("llama", **SHAPE)
    tcfg = tconfig.tiny_config("llama", **SHAPE)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][name] = tree["layers"][name] * np.float32(7.0)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), max_new_tokens=8,
              decode_budget=136, capacity_granularity=256, score_chunk_size=256,
              scoring_attend="window")
    jeng = JEngine("tiny-llama", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    teng = Engine("tiny-llama", config=tcfg, params=params_from_jax(tree, "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    jst = jeng.prefill(CTX_LONG, prefill_chunk_size=256)
    tst = teng.prefill(CTX_LONG, prefill_chunk_size=256)
    assert tst.ctx_len > 2 * 256  # three windows, the last one short
    j_score = np.asarray(jst.score)
    np.testing.assert_allclose(tst.score.numpy(), j_score, rtol=1e-5, atol=1e-5)

    keep, thres, _ = prune.prune_mask(tst.score, 0.3, "pair", method="histogram")
    j_keep = np.asarray(jprune.prune_mask(jnp.asarray(j_score), 0.3, "pair",
                                          method="histogram")[0])
    differ = keep.numpy() != j_keep
    assert not differ.any() or np.abs(j_score[differ] - float(thres)).max() < 1e-6

    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)


def test_window_rejects_hybrid_and_unknown_modes():
    cfg = tconfig.tiny_config("gemma3")
    with pytest.raises(ValueError, match="hybrid"):
        Engine("tiny-gemma3", config=cfg, dtype=torch.float32, device="cpu",
               scoring_attend="window")
    with pytest.raises(ValueError, match="scoring_attend"):
        _engine("sparse")
    with pytest.raises(ValueError, match="act_fused"):
        Engine("tiny-llama", config=tconfig.tiny_config("llama"), dtype=torch.float32,
               device="cpu", act_fused="triton")
