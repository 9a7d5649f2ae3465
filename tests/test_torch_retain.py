"""The port's retain path (``Engine(kv_type="retain")``), its masked
attention route (``attn_impl`` "dense" and "blockwise") and the engine's
route choice (``_impl``, ``_use_flat``) against ``kvzip_tpu``, float32 on
the CPU, one reference engine for the module.

Both packages prefill the same tokens; their scores agree to 1e-5, and
from there both prune with the reference's scores, so retain masks
compare exactly. Tolerances: ``valid`` masks equal; greedy tokens equal;
logits within 1e-4 (float32 sums in another order); the masked
attention functions within 1e-5 of the reference's on random rows.
The port's own holds: a retain prune keeps the same rows per head as the
dense compaction (``flat_decode="off"``) on the same scores, and their
next-token probabilities agree within the reference's 3e-3
(``tests/test_engine.py::test_retain_equals_evict``); the captured decode
step gives the per-token loop's tokens.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.engine import KVState as JKVState
from kvzip_tpu.models import params as jparams
from kvzip_tpu.ops import attention as jattn
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch.engine import Engine, KVState, generate_ids_per_token
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.ops import attention

from test_torch_engine import CTX, IdTokenizer, one_torch_thread  # noqa: F401

CTX_R = CTX[:700]
QUERY = "What is the password?"
SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2)
KW = dict(max_new_tokens=6, decode_budget=134, capacity_granularity=256,
          score_chunk_size=256)


def _tree(shape):
    t = jax.device_get(jparams.init_params(tiny_config("llama", **shape),
                                           jax.random.PRNGKey(0), jnp.float32))
    # weights at 7x the init scale, as in test_torch_engine.py
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        t["layers"][name] = t["layers"][name] * np.float32(7.0)
    return t


def port_engine(tree, shape=SHAPE, **kw):
    return Engine("tiny-llama", config=tconfig.tiny_config("llama", **shape),
                  params=params_from_jax(tree, "cpu", torch.float32),
                  tokenizer=IdTokenizer(512), dtype=torch.float32, device="cpu",
                  **{**KW, **kw})


@pytest.fixture(scope="module")
def engines():
    tree = _tree(SHAPE)
    jeng = JEngine("tiny-llama", kv_type="retain", config=tiny_config("llama", **SHAPE),
                   params=jax.tree_util.tree_map(jnp.asarray, tree),
                   tokenizer=IdTokenizer(512), dtype=jnp.float32, **KW)
    return jeng, port_engine(tree, kv_type="retain"), tree


def scored(jeng, teng):
    """Both packages' states of CTX_R, prefilled and scored; the port's
    scores then replaced by the reference's (held to 1e-5 first)."""
    jst = jeng.prefill(CTX_R, prefill_chunk_size=256)
    tst = teng.prefill(CTX_R, prefill_chunk_size=256)
    np.testing.assert_allclose(tst.score.numpy(), np.asarray(jst.score), rtol=1e-5, atol=1e-5)
    tst.score = torch.from_numpy(np.array(jst.score))
    return jst, tst


def test_retain_sweep_matches_reference(engines):
    """One prefill pruned at 0.3, 0.6 and 1.0: the same masks and answers,
    each ratio's answer after the same state's earlier ones."""
    jeng, teng, _ = engines
    jst, tst = scored(jeng, teng)
    assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)
    for ratio in (0.3, 0.6, 1.0):
        _, j_ratio = jeng.prune(jst, ratio, "pair")
        _, t_ratio = teng.prune(tst, ratio, "pair")
        assert t_ratio == pytest.approx(j_ratio)
        np.testing.assert_array_equal(tst.cache.valid.numpy(), np.asarray(jst.cache.valid))
        assert tst.score is not None and teng._impl(tst) == "dense"
        for _ in range(2):
            assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)
    assert tst.cache.valid.all()  # ratio 1.0 keeps every row


@pytest.mark.parametrize("level", ["pair-uniform", "head"])
def test_retain_levels_match_reference(engines, level):
    """Per-head top-k budgets, and head-level scores (each head's maximum
    over the context, broadcast): the same masks and answers."""
    jeng, teng, _ = engines
    jst, tst = scored(jeng, teng)
    if level == "head":
        head = np.array(jst.score).max(axis=-1, keepdims=True)
        head = np.broadcast_to(head, np.asarray(jst.score).shape).copy()
        jst.score, tst.score = jnp.asarray(head), torch.from_numpy(head)
    jeng.prune(jst, 0.5, level)
    teng.prune(tst, 0.5, level)
    np.testing.assert_array_equal(tst.cache.valid.numpy(), np.asarray(jst.cache.valid))
    if level == "head":
        ctx = tst.cache.valid[:, :, tst.sink:tst.prefill_len]
        assert (ctx.all(-1) | ~ctx.any(-1)).all()  # whole heads
    assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)


@pytest.mark.parametrize("impl", ["dense", "blockwise"])
def test_masked_route_logits_match_reference(engines, impl):
    """Teacher-forced logits through ``attn_impl`` "dense" and "blockwise"
    on an unpruned and a pruned retain state."""
    jeng, teng, _ = engines
    jeng.attn_impl = teng.attn_impl = impl
    try:
        jst, tst = scored(jeng, teng)
        seq = teng.apply_template(QUERY)
        for ratio in (None, 0.4):
            if ratio is not None:
                jeng.prune(jst, ratio, "pair")
                teng.prune(tst, ratio, "pair")
            assert teng._impl(tst) == jeng._impl(jst) == impl
            np.testing.assert_allclose(teng.forward_ids(seq, tst, return_logits=True),
                                       jeng.forward_ids(seq, jst, return_logits=True),
                                       rtol=1e-4, atol=1e-4)
    finally:
        jeng.attn_impl = teng.attn_impl = "auto"


@pytest.mark.parametrize("fn,block_scores", [("dense", None), ("blockwise", None),
                                              ("blockwise", 2048), ("blockwise_int4", None),
                                              ("blockwise_int4", 2048)])
@pytest.mark.parametrize("T", [1, 5, 40])
def test_masked_attention_matches_reference(monkeypatch, fn, block_scores, T):
    """The masked route's functions on random rows (kv heads' lengths far
    apart, a random retain mask, a capacity no multiple of the key block),
    the port's blockwise in blocks of 16 queries and 64 keys, every key
    block in one batched product or (``block_scores`` 2048) two at a time,
    against the reference's ``attend_dense``."""
    from kvzip_tpu.ops.quant import dequantize_int4 as jdeq
    from kvzip_tpu_torch.ops.quant import quantize_int4

    if block_scores:
        monkeypatch.setattr(attention, "BLOCK_SCORES", block_scores)
    rng = np.random.default_rng(T)
    H, Hkv, C, D = 6, 3, 300, 128
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((Hkv, C, D)).astype(np.float32) for _ in range(2))
    lens = np.array([5, 270, 140], np.int32)
    valid = rng.random((Hkv, C)) < 0.7
    args = dict(scale=D ** -0.5)
    if fn == "blockwise_int4":
        packed = [quantize_int4(torch.from_numpy(a), pack="split") for a in (k, v)]
        k, v = (np.asarray(jdeq(jnp.asarray(p.numpy()), jnp.asarray(s.numpy()),
                                jnp.asarray(z.numpy()), jnp.float32, pack="split"))
                for p, s, z in packed)
        rows = [a if i == 0 else a[..., 0] for p in packed for i, a in enumerate(p)]
        got = attention.attend_blockwise_int4(torch.from_numpy(q), rows[0], rows[1], rows[2],
                                              rows[3], rows[4], rows[5], torch.from_numpy(lens),
                                              torch.from_numpy(valid), kv_block=64, q_block=16,
                                              **args)
    else:
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tl, tvalid = torch.from_numpy(lens), torch.from_numpy(valid)
        got = (attention.attend_dense(tq, tk, tv, tl, tvalid, **args) if fn == "dense" else
               attention.attend_blockwise(tq, tk, tv, tl, tvalid, kv_block=64, q_block=16,
                                          **args))
    want = jattn.attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), jnp.asarray(valid), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_impl_and_use_flat_match_reference_head_dim_64():
    """For a head_dim-64 config (no kernel takes it) the port's route
    choice is the reference's on every kind of state: the masked route,
    "dense" up to 4,096 rows a head, and no decode layout under "auto"."""
    shape = dict(SHAPE, head_dim=64)
    tree = _tree(shape)
    for flat in ("auto", "on", "off", "legacy"):
        for attn_impl in ("auto", "dense", "blockwise"):
            jeng = JEngine("tiny-llama", config=tiny_config("llama", **shape),
                           params=jax.tree_util.tree_map(jnp.asarray, tree),
                           tokenizer=IdTokenizer(512), dtype=jnp.float32,
                           flat_decode=flat, attn_impl=attn_impl, **KW)
            teng = port_engine(tree, shape, flat_decode=flat, attn_impl=attn_impl)
            for kv_type in ("evict", "retain"):
                for pruned in (False, True):
                    for cap in (1024, 4096, 8192, 8320):
                        cache = types.SimpleNamespace(capacity=cap)
                        kw = dict(cache=cache, kv_type=kv_type, sink=3, ctx_len=10,
                                  prefill_len=13, pruned=pruned)
                        jst, tst = JKVState(**kw), KVState(**kw)
                        assert teng._impl(tst) == jeng._impl(jst), (flat, attn_impl, kw)
                        assert teng._use_flat(tst) == jeng._use_flat(jst), (flat, kw)


def test_impl_takes_any_capacity(engines):
    """A dense head_dim-128 cache whose capacity is no multiple of 128
    (capacity_granularity 100) runs the kernels' route ("flash") in the
    port, prefilled and compacted, where the reference's Mosaic block
    limit sends it to the masked route; its probabilities are the masked
    route's (1e-5) and it answers."""
    jeng, _, tree = engines
    eng = port_engine(tree, flat_decode="off", capacity_granularity=100)
    deng = port_engine(tree, flat_decode="off", capacity_granularity=100, attn_impl="dense")
    st = eng.prefill(CTX_R, prefill_chunk_size=256)
    q = eng.apply_template(QUERY)
    for pruned in (False, True):
        if pruned:
            eng.prune(st, 0.3, "pair")
        cap = st.cache.capacity
        assert cap % 100 == 0 and cap % 128 and eng._impl(st) == "flash"
        jst = JKVState(cache=types.SimpleNamespace(capacity=cap), kv_type="evict",
                       sink=st.sink, ctx_len=st.ctx_len, prefill_len=st.prefill_len,
                       pruned=pruned)
        assert jeng._impl(jst) == "dense"
        np.testing.assert_allclose(eng.prob(q, st), deng.prob(q, st), rtol=0, atol=1e-5)
        assert len(eng.generate_ids(QUERY, st)) == eng.max_new_tokens


def test_retain_equals_compact(engines):
    """The port's retain prune and its dense compaction on the same scores
    keep the same rows per head and predict alike (the reference's own
    hold); a compacted state refuses a second prune."""
    jeng, teng, tree = engines
    _, tst = scored(jeng, teng)
    ceng = port_engine(tree, flat_decode="off")
    q = teng.apply_template(QUERY)
    for ratio in (0.7, 0.4):
        teng.prune(tst, ratio, "pair")
        cst = ceng.prefill(CTX_R, prefill_chunk_size=256, do_score=False)
        cst.score = tst.score
        ceng.prune(cst, ratio, "pair")
        assert type(cst.cache).__name__ == "KVCache" and ceng._impl(cst) == "flash"
        kept = tst.cache.valid[:, :, :tst.prefill_len].sum(-1).to(torch.int32)
        assert torch.equal(cst.cache.lengths, kept)
        np.testing.assert_allclose(teng.prob(q, tst), ceng.prob(q, cst), atol=3e-3, rtol=0)
    with pytest.raises(RuntimeError, match="one-shot"):
        ceng.prune(cst, 0.2, "pair")


def test_retain_captured_step_matches_per_token_loop(engines):
    """The captured decode step over the masked route gives the per-token
    loop's answer, before and after a second prune (which drops the
    step)."""
    jeng, teng, _ = engines
    _, tst = scored(jeng, teng)
    for ratio in (0.3, 0.6):
        teng.prune(tst, ratio, "pair")
        assert not tst._steps
        got = teng.generate_ids(QUERY, tst)
        assert np.array_equal(got, generate_ids_per_token(teng, QUERY, tst))
        assert len(tst._steps) == 1
    with pytest.raises(ValueError, match="retain mask"):
        port_engine(engines[2], kv_type="retain", attn_impl="flash")._impl(tst)
