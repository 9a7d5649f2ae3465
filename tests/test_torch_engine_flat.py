"""The port's legacy flat decode layout (``Engine(flat_decode="legacy")``)
end to end on the CPU, in float32.

bf16 path: against ``kvzip_tpu.Engine(flat_decode="legacy")`` on the same
tiny config, weights and token ids (one reference engine for the module):
the same keep mask (flat ``lengths`` and ``row_head``), flat rows within
1e-4 (K and V of magnitude up to ~5 after two float32 layers summed in
different orders), the same greedy tokens, and the same tokens over kept turns until
both have folded their tail into the flat rows (``refold_flat``).

int4 KV + W4A8 + int8 embedding, and ``attn_quant="int8"``: held without a
second reference engine. One scored state is pruned twice, into the port's
pool and into its flat layout; both decode exact attention over the same
kept rows, so their next-token probabilities agree to 1e-5 and their greedy
tokens are equal (the pool path is held against the reference in
``test_torch_engine_quant.py``, the flat kernels at the op level in
``test_torch_flat.py``). The reference's engine ignores ``attn_quant`` on
the CPU, so the int8 mode is held against the exact mode with the
reference's own tolerance for it (rtol = atol = 0.05,
``tests/test_flat_int4.py``), on both layouts.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch.cache import FlatInt4KV, FlatKV
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.pool import PoolInt4KV

from test_torch_engine import CTX, IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_engine_quant import QUANT, QUERY_Q

CTX_Q = CTX[:700]
SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2)
KW = dict(max_new_tokens=4, decode_budget=132, capacity_granularity=256,
          score_chunk_size=256)


@pytest.fixture(scope="module")
def tree():
    t = jax.device_get(jparams.init_params(tiny_config("llama", **SHAPE),
                                           jax.random.PRNGKey(0), jnp.float32))
    # weights at 7x the init scale, as in test_torch_engine.py
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        t["layers"][name] = t["layers"][name] * np.float32(7.0)
    return t


def _port(tree, **kw):
    return Engine("tiny-llama", config=tconfig.tiny_config("llama", **SHAPE),
                  params=params_from_jax(tree, "cpu", torch.float32),
                  tokenizer=IdTokenizer(512), dtype=torch.float32, device="cpu",
                  **KW, **kw)


@pytest.fixture(scope="module")
def pruned(tree):
    """The reference and the port, legacy flat, prefilled, scored and
    pruned at 0.3 from the same tokens."""
    jeng = JEngine("tiny-llama", config=tiny_config("llama", **SHAPE),
                   params=jax.tree_util.tree_map(jnp.asarray, tree),
                   tokenizer=IdTokenizer(512), dtype=jnp.float32,
                   flat_decode="legacy", **KW)
    teng = _port(tree, flat_decode="legacy")
    jst = jeng.prefill(CTX_Q, prefill_chunk_size=256)
    tst = teng.prefill(CTX_Q, prefill_chunk_size=256)
    np.testing.assert_allclose(tst.score.numpy(), np.asarray(jst.score), rtol=1e-5, atol=1e-5)
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    return jeng, teng, jst, tst


def test_legacy_flat_prune_matches_reference(pruned):
    """The same kept rows in the same flat order: lengths and row_head
    equal, K (row-major here, transposed in the reference) and V within
    1e-4."""
    _, _, jst, tst = pruned
    assert isinstance(tst.cache, FlatKV)
    jc = jst.cache
    np.testing.assert_array_equal(tst.cache.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tst.cache.row_head.numpy(), np.asarray(jc.row_head))
    np.testing.assert_allclose(tst.cache.k_flat.numpy(),
                               np.swapaxes(np.asarray(jc.k_flat), 1, 2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tst.cache.v_flat.numpy(), np.asarray(jc.v_flat),
                               rtol=1e-4, atol=1e-4)
    assert tst.cache.seen == int(jc.seen) and tst.cache.tail_len == 0


def test_legacy_flat_greedy_tokens_and_refold_match_reference(pruned):
    jeng, teng, jst, tst = pruned
    for _ in range(2):  # the second runs after the O(1) restore
        assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
    assert tst.cache.tail_len == 0
    turn = 0
    while tst.refolds == 0:
        q = f"Turn {turn}: and then?"
        assert teng.generate(q, tst, update_cache=True) == \
            jeng.generate(q, jst, update_cache=True)
        turn += 1
        assert turn < 12, "no refold"
    # the reference folded at the same turn: its tail holds this turn only
    assert tst.cache.tail_len == int(jst.cache.tail_len)
    np.testing.assert_array_equal(tst.cache.row_head.numpy(), np.asarray(jst.cache.row_head))
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)


def test_legacy_flat_forward_passes_live_rows(pruned, monkeypatch):
    """forward gives K10 each layer's live rows (``seg_rows``, the count of
    row_head >= 0) at every call, and the greedy tokens with it are the
    reference's (after the refold above, on the refolded rows)."""
    from kvzip_tpu_torch.models import transformer

    jeng, teng, jst, tst = pruned
    seen, real = [], transformer.flat_decode_attend

    def spy(*args, **kw):
        seen.append(kw["seg_rows"])
        return real(*args, **kw)

    monkeypatch.setattr(transformer, "flat_decode_attend", spy)
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
    want = (tst.cache.row_head >= 0).sum(-1, keepdim=True).to(torch.int32)
    assert seen and all(torch.equal(s, want) for s in seen)


def test_flatten_full_and_synthetic_full_flat(tree):
    """flatten_full keeps every row: its next-token probabilities equal the
    dense cache's; the synthetic full flat caches (every layer padded to
    the reference's r_pad bucket, 8192 rows here) decode."""
    teng = _port(tree, flat_decode="legacy")
    st = teng.prefill(CTX_Q, prefill_chunk_size=256, do_score=False)
    full = teng.flatten_full(st)
    assert isinstance(full.cache, FlatKV)
    np.testing.assert_array_equal(full.cache.lengths.numpy(), st.sink + st.ctx_len)
    q = teng.encode(QUERY_Q)
    np.testing.assert_allclose(teng.prob(q, full), teng.prob(q, st), rtol=1e-5, atol=1e-5)
    for int4 in (False, True):
        syn = teng.synthetic_full_flat_state(st, int4, teng.decode_budget)
        assert isinstance(syn.cache, FlatInt4KV if int4 else FlatKV)
        np.testing.assert_array_equal(syn.cache.lengths.numpy(), full.cache.lengths.numpy())
        assert len(teng.generate_ids(QUERY_Q, syn)) > 0


@pytest.fixture(scope="module")
def quant_layouts(tree):
    """One int4 + W4A8 scored state pruned into the pool and into the
    legacy flat layout, each with an exact and an int8-attention engine
    (the same parameters)."""
    pool_eng = _port(tree, **QUANT)
    st = pool_eng.prefill(CTX_Q, prefill_chunk_size=256)
    st_flat = dataclasses.replace(st, cache=copy.deepcopy(st.cache), score=st.score.clone())
    flat_eng = copy.copy(pool_eng)
    flat_eng.flat_decode = "legacy"
    pool_eng.prune(st, 0.3, "pair")
    flat_eng.prune(st_flat, 0.3, "pair")
    out = {}
    for name, eng, state in (("pool", pool_eng, st), ("flat", flat_eng, st_flat)):
        q8 = copy.copy(eng)
        q8.attn_quant = "int8"
        out[name] = (eng, q8, state)
    return out


def test_int4_flat_and_pool_decode_the_same_rows(quant_layouts):
    pool_eng, _, pst = quant_layouts["pool"]
    flat_eng, _, fst = quant_layouts["flat"]
    assert isinstance(pst.cache, PoolInt4KV) and isinstance(fst.cache, FlatInt4KV)
    np.testing.assert_array_equal(fst.cache.lengths.numpy(), pst.cache.lengths.numpy())
    p, f = pst.cache, fst.cache
    for l, n in enumerate(p.layer_rows.tolist()):
        o = int(p.layer_off[l])
        for pf, ff in (("k_pool_q", "k_flat_q"), ("v_pool_s", "v_flat_s"),
                       ("row_head", "row_head")):
            assert torch.equal(getattr(p, pf)[o:o + n], getattr(f, ff)[l, :n]), (l, ff)
    q = pool_eng.encode(QUERY_Q)
    np.testing.assert_allclose(flat_eng.prob(q, fst), pool_eng.prob(q, pst),
                               rtol=1e-5, atol=1e-5)
    assert flat_eng.generate(QUERY_Q, fst) == pool_eng.generate(QUERY_Q, pst)


@pytest.mark.parametrize("layout", ["pool", "flat"])
def test_int8_attention_stays_near_exact(quant_layouts, layout):
    eng, q8, st = quant_layouts[layout]
    q = eng.encode(QUERY_Q)
    exact = eng.prob(q, st)
    got = q8.prob(q, st)
    assert np.isfinite(got).all()
    assert np.abs(got - exact).max() > 0  # the int8 mode really ran
    np.testing.assert_allclose(got, exact, rtol=0.05, atol=0.05)
    assert len(q8.generate_ids(QUERY_Q, st)) > 0
    assert st.cache.tail_len == 0


def test_decode_layout_options_validate(tree):
    """``flat_decode="off"`` (the dense compaction) is a layout of the port:
    its evict prune compacts the dense cache; unknown layouts and attention
    modes raise."""
    eng = _port(tree, flat_decode="off")
    st = eng.prefill(CTX_Q, prefill_chunk_size=256)
    eng.prune(st, 0.3, "pair")
    assert type(st.cache).__name__ == "KVCache" and eng._impl(st) == "flash"
    assert st.cache.capacity < st.prefill_len and len(eng.generate_ids(QUERY_Q, st)) > 0
    with pytest.raises(ValueError, match="flat_decode"):
        _port(tree, flat_decode="pool")
    with pytest.raises(ValueError, match="attn_quant"):
        _port(tree, attn_quant="fp8")
    assert _port(tree, flat_decode="on", attn_quant="int8").attn_quant == "int8"
