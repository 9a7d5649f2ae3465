"""Per-rank pools (``parallel/pool_tp.py``), their guards, and the ring
prefill (``parallel/ring_prefill.py``) against the reference, on the CPU:
the cases of ``tests/test_pool_tp.py`` and ``tests/test_ring_prefill.py``.

One gloo group of four spawned ranks runs every case
(``torch_parallel_ranks.pool_cases``, no JAX); the reference runs in this
process on the same config, weights and token ids, single-device (its
mesh engines equal it to their own tests' tolerance; its pool and its
compaction give the same attention):

- pool-TP at data 2 x model 2, bf16 and int4 KV, pair and head levels:
  each rank an ordinary pool over its kv head (``tp`` 2 on it), kept rows
  a head equal to the reference's (int4 pair: within 2, the reference
  test's wobble on continuous scores), scores within 1e-4, greedy tokens
  equal;
- the guards: a TP pool's tail refold raises ``NotImplementedError``,
  ``save_state`` the "mesh-specific" ``ValueError``, the merged pool and
  a batch of pool states on a mesh ``NotImplementedError``, each with the
  reference's message;
- the ring at data 4 (model 1): every rank's K/V slab within 1e-4 of the
  reference's sequential prefill's rows;
- ``Engine(seq_parallel=True)`` at data 2 x model 2 on 517 random tokens
  (a ring prefix and a sequential remainder): scores within 2e-3 (the
  reference test's), greedy tokens equal;
- ring K/V resharded into a TP engine's cache (``reshard_to_cache``),
  then 24 tokens' next-token probabilities within 1e-3 (the reference
  test's) of the reference's sequential ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from kvzip_tpu.config import tiny_config as jtiny
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.tokenizer import ByteTokenizer
from kvzip_tpu_torch.config import tiny_config
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.parallel import dryrun

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_parallel import TOL, _answer_ids, _whole

CTX = ("Relay four reported beacon 7731 offline; the Peregrine rerouted "
       "through sector nine carrying medical cargo. " * 4)
QUESTION = "Which beacon went offline?"
POOL_CFG = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128)


def _jengine(jcfg, tree, **kw):
    base = dict(kv_type="evict", max_new_tokens=6, decode_budget=256,
                capacity_granularity=256, score_chunk_size=256)
    return JEngine("tiny-llama", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, tokenizer=ByteTokenizer(jcfg.vocab_size),
                   **{**base, **kw})


@pytest.fixture(scope="module")
def reference():
    out, cases = {}, {}
    jcfg = jtiny("llama", **POOL_CFG)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
    L, H = jcfg.num_layers, jcfg.num_kv_heads
    head_scores = np.linspace(0.1, 1.0, L * H, dtype=np.float32).reshape(L, H)
    for kv_quant in ("none", "int4"):
        jeng = _jengine(jcfg, tree, kv_quant=kv_quant)
        ctx, query = jeng.encode(CTX), jeng.apply_template(QUESTION)
        scored = jeng.prefill(ctx, prefill_chunk_size=200)
        score = np.asarray(scored.score)
        for level in ("pair", "head"):
            jst = dataclasses.replace(scored, cache=jax.tree_util.tree_map(jnp.copy, scored.cache),
                                      score=jnp.copy(scored.score))
            jst.snapshot()
            if level == "head":
                jst.score = jnp.asarray(np.broadcast_to(head_scores[:, :, None],
                                                        (L, H, jst.ctx_len)))
            jeng.prune(jst, 0.5, level)
            out["pool", kv_quant, level] = dict(
                score=score, lengths=np.asarray(jst.cache.lengths),
                answer=_answer_ids(jeng, jst, query))
    cases["pool"] = dict(cfg=tiny_config("llama", **POOL_CFG), ctx=ctx, query=query,
                         params=params_from_jax(tree, "cpu", torch.float32),
                         head_scores=head_scores)

    jcfg = jtiny("llama")
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(11), jnp.float32))
    jeng = _jengine(jcfg, tree, kv_type="retain", max_new_tokens=4)
    sink = len(jeng.sys_prompt_ids)
    rng = np.random.default_rng(0)
    total = ((sink + 512) // 8) * 8
    ctx = rng.integers(1, jcfg.vocab_size - 4, size=total - sink).astype(np.int32)
    full = np.concatenate([jeng.sys_prompt_ids, ctx]).astype(np.int32)
    jst = jeng.prefill(ctx, prefill_chunk_size=256, do_score=False)
    out["ring_kv"] = dict(k=np.asarray(jst.cache.k)[:, :, :total],
                          v=np.asarray(jst.cache.v)[:, :, :total])
    q24 = np.random.default_rng(2).integers(1, jcfg.vocab_size - 4, size=24).astype(np.int32)
    out["reshard"] = dict(prob=jeng.prob(q24, jst))
    ctx517 = np.random.default_rng(7).integers(1, jcfg.vocab_size - 4, size=517).astype(np.int32)
    query = jeng.apply_template("Summarize.")
    jst = jeng.prefill(ctx517, prefill_chunk_size=256)
    score = np.asarray(jst.score)
    jeng.prune(jst, 0.5, "pair")
    out["seq_parallel"] = dict(score=score, answer=_answer_ids(jeng, jst, query))
    cases["ring"] = dict(cfg=tiny_config("llama"), params=params_from_jax(tree, "cpu", torch.float32),
                         ctx=ctx, full=full, ctx517=ctx517, query=query, q24=q24)
    return out, cases


@pytest.fixture(scope="module")
def ranks_out(reference):
    return dryrun.spawn(4, ranks.pool_cases, reference[1])


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
@pytest.mark.parametrize("level", ["pair", "head"])
def test_pool_tp_decode_matches_reference(reference, ranks_out, kv_quant, level):
    want = reference[0]["pool", kv_quant, level]
    got = [r["pool", kv_quant, level] for r in ranks_out]
    np.testing.assert_allclose(_whole(got, "score"), want["score"], rtol=TOL, atol=TOL)
    for r in got:
        assert r["is_pool"] and r["tp"] == 2
        assert r["kind"] == ("PoolInt4KV" if kv_quant == "int4" else "PoolKV")
    lens = _whole(got, "lengths").astype(np.int64)
    ref_lens = want["lengths"].astype(np.int64)
    if kv_quant == "int4" and level == "pair":
        assert np.abs(lens - ref_lens).max() <= 2
    else:
        np.testing.assert_array_equal(lens, ref_lens)
        for r in got:
            assert r["answer"].tolist() == want["answer"]


@pytest.mark.parametrize("guard, kind, message", [
    ("refold", "NotImplementedError", "tail refold of a tensor-parallel pool"),
    ("save_state", "ValueError", "mesh-specific"),
    ("merge_pool", "NotImplementedError", "merged-pool batching of tensor-parallel pools"),
    ("batched", "NotImplementedError", "pool caches batch through the single-device"),
])
def test_pool_tp_guards(ranks_out, guard, kind, message):
    for r in ranks_out:
        got = r["guards"][guard]
        assert got is not None and got[0] == kind and message in got[1], got


def test_ring_prefill_matches_sequential(reference, ranks_out):
    want = reference[0]["ring_kv"]
    n = len(ranks_out)
    S = want["k"].shape[2] // n
    for r in ranks_out:
        d = r["ring_kv"]["data"]
        for f in ("k", "v"):
            np.testing.assert_allclose(r["ring_kv"][f], want[f][:, :, d * S:(d + 1) * S],
                                       rtol=TOL, atol=TOL)


def test_engine_seq_parallel_full_pipeline(reference, ranks_out):
    want = reference[0]["seq_parallel"]
    got = [r["seq_parallel"] for r in ranks_out]
    np.testing.assert_allclose(_whole(got, "score"), want["score"], atol=2e-3, rtol=0)
    for r in got:
        assert r["answer"].tolist() == want["answer"]


def test_ring_prefill_reshard_decodes(reference, ranks_out):
    for r in ranks_out:
        np.testing.assert_allclose(r["reshard"]["prob"], reference[0]["reshard"]["prob"],
                                   atol=1e-3, rtol=0)
