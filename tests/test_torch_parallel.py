"""The port's head-sharded tensor parallelism (``kvzip_tpu_torch/parallel``)
against the reference, on the CPU: the cases of ``tests/test_parallel.py``.

The sharding tables are checked here in the test process (shard shapes
per rank, W4A8 replicated, the port's W8A8 axes, an uneven vocabulary, a
kv head shared by two ranks, a batch-stacked cache on a replica mesh). The engines run in ONE gloo group of four
spawned ranks (``parallel/dryrun.py::spawn``; the rank program is
``torch_parallel_ranks.tp_cases``, which imports no JAX) on the
reference's weights (``params_from_jax``) and token ids; the reference
runs in this process on the same config, weights and ids. Its mesh engine
is the reference's single-device engine to its own tests' tolerance
(``tests/test_parallel.py``), which compiles in a fraction of the time,
so each case holds the port's mesh engine against the reference engine:

- TP=4 llama (evict, compaction): scores within 1e-4 (float32, the
  ranks' all-reduces sum in another order), kept rows a head equal,
  next-token probabilities within 1e-4, greedy tokens equal (the int4
  mesh is ``test_torch_parallel_pool.py``'s int4 pool cases; the port's
  TP engine against its single-device one is the W8A8 case);
- gemma3 (hybrid ring cache, retain): scores 1e-4, probabilities 1e-4;
- the histogram threshold over head-sharded scores (pair, head-broadcast
  ties, a kv head two ranks share, the rank guard's fallback): the keep
  mask and threshold of the reference's global sort, exactly;
- W8A8 under TP: a row-parallel activation's int8 bytes and scale equal
  the single-device quantization's (a rank's own maximum would differ),
  K14 over the gathered row too; the W8A8 engine's (K13/K14, and wo's
  row-wide quantization) greedy tokens and probabilities those of the
  single-device port's
  (itself held against the reference in ``test_torch_engine_w8a8.py``);
- data 2 x model 2 (the TP=4 case's weights, context and prune): its
  kept rows and the reference's greedy tokens.

The context is shorter than the reference tests' (about 500 tokens, two
scoring windows), so that the four ranks and the reference engines stay
within a minute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from kvzip_tpu import prune as jprune
from kvzip_tpu.config import tiny_config as jtiny
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.tokenizer import ByteTokenizer
from kvzip_tpu_torch.config import tiny_config
from kvzip_tpu_torch.models.params import init_params, params_from_jax
from kvzip_tpu_torch.parallel import dryrun
from kvzip_tpu_torch.parallel.mesh import (P, local_cache, local_params, param_sharding,
                                           shard_geometry)

from test_torch_engine import one_torch_thread  # noqa: F401

CTX = ("Sharded caches should behave identically. " * 6 +
       "The secret word is zanzibar. " +
       "Filler sentence for the long tail of the context. " * 4)
QUESTION = "What is the secret word?"
TOL = 1e-4


def _tree(jcfg, seed: int) -> dict:
    return jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))


def _jengine(jcfg, tree, name="tiny-llama", **kw):
    base = dict(kv_type="evict", max_new_tokens=8, decode_budget=256,
                capacity_granularity=256, score_chunk_size=256)
    return JEngine(name, config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, tokenizer=ByteTokenizer(jcfg.vocab_size),
                   **{**base, **kw})


def _ids(jeng, text: str) -> np.ndarray:
    return jeng.encode(text).astype(np.int32)


def _whole(parts: list, key: str) -> np.ndarray:
    """A per-kv-head array (L, Hkv_local, ...) assembled from the ranks
    (each kv head once)."""
    got = {}
    for r in parts:
        kv0, hkv, rep_idx = r["heads"]
        if rep_idx == 0:
            got[kv0] = r[key]
    return np.concatenate([got[k] for k in sorted(got)], axis=1)


def _answer_ids(jeng, jst, query) -> list:
    """The reference's greedy answer as ids (its tokenizer decodes bytes)."""
    jeng.tokenizer.decode = lambda ids, **kw: list(np.asarray(ids).reshape(-1))
    return [int(t) for t in jeng.generate(query, jst)]


# ------------------------------------------------------------ the tables
def test_shard_shapes_per_rank():
    """Every rank's part of the tree by the spec table: heads, kv heads,
    intermediate and vocabulary split; norms whole; the parts cover the
    tree."""
    cfg = tiny_config("qwen2")  # qkv bias
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    for tp in (1, 2, 4):
        parts = [local_params(cfg, params, tp, r) for r in range(tp)]
        for r, p in enumerate(parts):
            lp, Dh = p["layers"], cfg.head_dim
            assert lp["wq"].shape == (4, 128, 8 // tp * Dh)
            assert lp["wk"].shape == lp["wv"].shape == (4, 128, 4 // tp * Dh)
            assert lp["wo"].shape == (4, 8 // tp * Dh, 128)
            assert lp["w_gate"].shape == lp["w_up"].shape == (4, 128, 256 // tp)
            assert lp["w_down"].shape == (4, 256 // tp, 128)
            assert lp["bk"].shape == (4, 4 // tp * Dh)
            assert p["embed"].shape == p["lm_head"].shape == (512 // tp, 128)
            assert lp["ln_attn"].shape == (4, 128) and p["final_norm"].shape == (128,)
        for name, dim in (("wq", 2), ("wk", 2), ("wo", 1), ("w_down", 1)):
            torch.testing.assert_close(
                torch.cat([p["layers"][name] for p in parts], dim=dim), params["layers"][name],
                rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([p["embed"] for p in parts]), params["embed"],
                                   rtol=0, atol=0)


def test_w4a8_replicated_and_w8a8_axes():
    """W4A8 dicts (and the biases beside them) stay whole on every rank;
    the port's W8A8 bytes (L, out, in) split out for column-parallel and
    in for row-parallel weights, their scales with the output channel."""
    from kvzip_tpu_torch.models.params import prepare_params

    cfg = tiny_config("qwen2")
    gen = torch.Generator().manual_seed(0)
    w4 = prepare_params(cfg, None, dtype=torch.float32, weight_quant="w4a8", generator=gen,
                        device="cpu")
    specs = param_sharding(cfg, None, w4)
    assert all(s == P() for s in specs["layers"]["wqkv"].values())
    assert specs["layers"]["bq"] == P()
    part = local_params(cfg, w4, 4, 3)
    for name, w in w4["layers"].items():
        if isinstance(w, dict):
            assert all(torch.equal(part["layers"][name][k], v) for k, v in w.items())
    w8 = prepare_params(cfg, None, dtype=torch.float32, weight_quant="w8a8",
                        generator=torch.Generator().manual_seed(0), device="cpu")
    specs = param_sharding(cfg, None, w8)
    assert specs["layers"]["wq"] == {"q": P(None, "model", None), "s": P(None, "model")}
    assert specs["layers"]["wo"] == {"q": P(None, None, "model"), "s": P(None, None)}
    part = local_params(cfg, w8, 2, 1)
    q = w8["layers"]["wq"]["q"]
    assert torch.equal(part["layers"]["wq"]["q"], q[:, q.shape[1] // 2:])
    assert torch.equal(part["layers"]["wq"]["s"], w8["layers"]["wq"]["s"][:, q.shape[1] // 2:])
    d = w8["layers"]["w_down"]["q"]
    assert torch.equal(part["layers"]["w_down"]["q"], d[:, :, d.shape[2] // 2:])
    assert torch.equal(part["layers"]["w_down"]["s"], w8["layers"]["w_down"]["s"])


def test_uneven_vocabulary_and_shared_kv_heads():
    """A vocabulary that "model" does not divide: chunks of ceil(V/tp) rows,
    the last shorter; tp above the kv heads: each kv head on tp/Hkv ranks,
    its query heads split among them; the cache's heads follow."""
    from kvzip_tpu_torch.cache import init_cache

    cfg = tiny_config("llama", vocab_size=510, num_kv_heads=2)
    geo = [shard_geometry(cfg, 4, r) for r in range(4)]
    assert [(g.v0, g.v1) for g in geo] == [(0, 128), (128, 256), (256, 384), (384, 510)]
    assert [(g.kv0, g.Hkv, g.h0, g.H, g.rep_idx) for g in geo] == [
        (0, 1, 0, 2, 0), (0, 1, 2, 2, 1), (1, 1, 4, 2, 0), (1, 1, 6, 2, 1)]
    cache = init_cache(cfg, 64, torch.float32, "cpu")
    cache.k.normal_()
    for g in geo:
        part = local_cache(cache, 2, 4, g.rank)
        assert torch.equal(part.k, cache.k[:, g.kv0:g.kv0 + 1])
        assert part.lengths.shape == (4, 1)
    with pytest.raises(ValueError, match="incompatible"):
        shard_geometry(tiny_config("llama", num_kv_heads=4, num_heads=12), 3, 0)


class _Coords:
    """A DeviceMesh's axes and this rank's coordinates, without a group."""

    def __init__(self, sizes: dict, coords: dict):
        self.mesh_dim_names = tuple(sizes)
        self._sizes, self._coords = list(sizes.values()), coords

    def size(self, i):
        return self._sizes[i]

    def get_local_rank(self, name):
        return self._coords[name]


def test_shard_batched_cache():
    """A batch-stacked cache on ("replica", "data", "model") = (2, 1, 2):
    the batch over the two batch shards (replica-major), the kv heads over
    "model"; a batch the shards do not divide stays whole."""
    from kvzip_tpu_torch.cache import KVCache
    from kvzip_tpu_torch.parallel.mesh import batch_axes, shard_batched_cache

    mesh = _Coords({"replica": 2, "data": 1, "model": 2}, {"replica": 1, "data": 0, "model": 1})
    assert batch_axes(mesh) == ("replica", "data")
    g = torch.Generator().manual_seed(0)
    for B, rows in ((4, slice(2, 4)), (3, slice(0, 3))):
        stacked = object.__new__(KVCache)
        stacked.k = torch.randn(B, 2, 4, 8, 16, generator=g)
        stacked.v = torch.randn(B, 2, 4, 8, 16, generator=g)
        stacked.lengths = torch.arange(B * 8, dtype=torch.int32).reshape(B, 2, 4)
        stacked.valid = torch.ones(B, 2, 4, 8, dtype=torch.bool)
        stacked.seen = torch.arange(B, dtype=torch.int32)
        part = shard_batched_cache(mesh, stacked)
        assert torch.equal(part.k, stacked.k[rows, :, 2:4])
        assert torch.equal(part.lengths, stacked.lengths[rows, :, 2:4])
        assert torch.equal(part.seen, stacked.seen[rows])


# -------------------------------------------------------- the mesh engines
@pytest.fixture(scope="module")
def reference():
    """The reference engines of each case, their states and the rank
    programs' inputs."""
    out, cases = {}, {}
    for key, family, seed, kw, name in (
            ("llama", "llama", 3, {}, "tiny-llama"),
            ("gemma3", "gemma3", 5, dict(kv_type="retain", decode_budget=64), "tiny-gemma3")):
        shape = {}
        jcfg = jtiny(family, **shape)
        tree = _tree(jcfg, seed)
        jeng = _jengine(jcfg, tree, name, **kw)
        ctx, query = _ids(jeng, CTX), jeng.apply_template(QUESTION)
        jst = jeng.prefill(ctx, prefill_chunk_size=300)
        score = np.asarray(jst.score)
        jeng.prune(jst, 0.5, "pair")
        out[key] = dict(score=score, lengths=np.asarray(jst.cache.lengths),
                        prob=jeng.prob(query, jst), answer=_answer_ids(jeng, jst, query))
        cases[key] = dict(cfg=tiny_config(family, **shape), name=name, ctx=ctx, query=query,
                          params=params_from_jax(tree, "cpu", torch.float32), engine=kw)

    rng = np.random.default_rng(0)
    score = jnp.asarray(rng.gamma(0.4, 1.0, size=(4, 8, 512)).astype(np.float32)
                        ).astype(jnp.bfloat16).astype(jnp.float32)
    head = jnp.asarray(rng.gamma(0.4, 1.0, size=(4, 8)).astype(np.float32)
                       ).astype(jnp.bfloat16).astype(jnp.float32)
    bcast = jnp.broadcast_to(head[:, :, None], (4, 8, 512))
    shared = score[:, :2]
    rng3 = np.random.default_rng(3)
    raw = np.concatenate([rng3.normal(1.0, 1e-6, size=6000),
                          rng3.gamma(0.2, 5.0, size=10384)]).astype(np.float32).reshape(4, 8, 512)
    ratios = {"pair": (0.1, 0.3, 0.5, 0.9), "head": (0.3, 0.6), "shared": (0.3, 0.7)}
    hist = {}
    for name, s in (("pair", score), ("head", bcast), ("shared", shared), ("guard", raw)):
        for ratio in ratios["pair" if name == "guard" else name]:
            hist[name, ratio] = tuple(np.asarray(a) for a in jprune.threshold_global(
                jnp.asarray(s), ratio))
    out["hist"] = hist
    cases["hist"] = dict(score=np.asarray(score), bcast=np.asarray(bcast),
                         shared=np.asarray(shared), raw=raw, ratios=ratios,
                         cfg={8: tiny_config("llama", num_kv_heads=8),
                              2: tiny_config("llama", num_kv_heads=2)})

    jcfg = jtiny("llama")
    ctx, query = cases["llama"]["ctx"], cases["llama"]["query"]
    rng = np.random.default_rng(5)
    cases["w8"] = dict(cfg=tiny_config("llama"), params=cases["llama"]["params"],
                       ctx=ctx, query=query,
                       x=rng.standard_normal((5, 256)).astype(np.float32),
                       gate=rng.standard_normal((5, 256)).astype(np.float32),
                       up=rng.standard_normal((5, 256)).astype(np.float32))

    cases["dp_tp"] = cases["llama"]
    return out, cases


@pytest.fixture(scope="module")
def ranks_out(reference):
    return dryrun.spawn(4, ranks.tp_cases, reference[1])


def test_tp4_matches_reference(reference, ranks_out):
    want = reference[0]["llama"]
    got = [r["llama"] for r in ranks_out]
    np.testing.assert_allclose(_whole(got, "score"), want["score"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_whole(got, "lengths"), want["lengths"])
    for r in got:  # every rank the whole vocabulary, the same tokens
        np.testing.assert_allclose(r["prob"], want["prob"], atol=TOL, rtol=0)
        assert r["answer"].tolist() == want["answer"]


def test_hybrid_mesh_matches_reference(reference, ranks_out):
    want = reference[0]["gemma3"]
    got = [r["gemma3"] for r in ranks_out]
    np.testing.assert_allclose(_whole(got, "score"), want["score"], rtol=TOL, atol=TOL)
    for r in got:
        np.testing.assert_allclose(r["prob"], want["prob"], atol=TOL, rtol=0)
        assert r["answer"].tolist() == want["answer"]


@pytest.mark.parametrize("name", ["pair", "head", "shared", "guard"])
def test_histogram_threshold_over_ranks_matches_sort(reference, ranks_out, name):
    want = reference[0]["hist"]
    for (case, ratio), (keep, thres) in want.items():
        if case != name:
            continue
        parts, seen = {}, set()
        for r in ranks_out:
            kv0, valid, t, *guard = r["hist"][name, ratio]
            assert abs(t - float(thres)) < 1e-6
            if name == "guard":
                assert guard == [True]
            if kv0 not in seen:
                seen.add(kv0)
                parts[kv0] = valid
        got = np.concatenate([parts[k] for k in sorted(parts)], axis=1)
        np.testing.assert_array_equal(got, keep)


def test_w8a8_activation_scales_match_single_device(reference, ranks_out):
    for r in ranks_out:
        act = r["w8_act"]
        assert act["bytes_equal"] and act["scales_equal"]
        assert act["k14_bytes_equal"] and act["k14_scales_equal"]
        assert act["local_scale_differs"]  # what a rank's own maximum would give
    for r in ranks_out:
        assert r["w8"]["answer"].tolist() == r["w8"]["single"].tolist()
        np.testing.assert_allclose(r["w8"]["prob"], r["w8"]["single_prob"], atol=TOL, rtol=0)


def test_dp_tp_mesh_generate(reference, ranks_out):
    want = reference[0]["llama"]
    assert sorted(r["dp_tp"]["data"] for r in ranks_out) == [0, 0, 1, 1]
    np.testing.assert_array_equal(_whole([r["dp_tp"] for r in ranks_out], "lengths"),
                                  want["lengths"])
    for r in ranks_out:
        assert r["dp_tp"]["answer"].tolist() == want["answer"]
