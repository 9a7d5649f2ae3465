"""The decode loop as one step with no host read (``engine.DecodeStep``)
against the reference's on-device loop (``kvzip_tpu/engine.py::
_decode_loop``), in float32 on the CPU, where the step runs eagerly in the
same loop the card replays as a CUDA graph.

One reference engine and one port engine with the same tiny weights; each
case sets both engines' ``kv_quant`` and ``flat_decode`` and prunes both
states with the same scores (drawn from a seed, so no scoring pass runs):
the bf16 pool, the int4 pool, the legacy flat layout, and a dense cache
(no prune). Held: the greedy tokens of ``generate`` equal the reference's
with ``update_cache`` false and true, and with an eos token the answer
emits (``eos_ids`` set to it) so that the answer ends inside a chunk of
``DECODE_CHUNK`` steps; the counters after each generate (``tail_len``,
``seen``, ``lengths``) equal the reference state's; a multi-turn run with
a refold. Then, on the port alone: ``restore`` keeps the counters'
tensors, and ``ops.LAUNCHES`` after a generate equals the per-token loop's
(``generate_ids_per_token``) count, the plain wrappers counted by a
wrapper that stands in for their launches; a call that needs more tail
rows than a pool or flat cache holds raises before it writes any.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu_torch import engine as engine_lib
from kvzip_tpu_torch.cache import FlatKV, KVCache, restore, snapshot
from kvzip_tpu_torch.engine import DECODE_CHUNK, generate_ids_per_token
from kvzip_tpu_torch.models import transformer
from kvzip_tpu_torch.ops import LAUNCHES, reset_launches
from kvzip_tpu_torch.pool import PoolInt4KV, PoolKV
from test_torch_engine import CTX, QUERY, _engines, one_torch_thread  # noqa: F401

KINDS = {"pool": ("none", "on", PoolKV), "int4_pool": ("int4", "on", PoolInt4KV),
         "flat": ("none", "legacy", FlatKV), "dense": ("none", "on", KVCache)}
MAX_NEW = 12  # two chunks: 8 steps, then 3


@pytest.fixture(scope="module")
def engines():
    jeng, teng = _engines()
    for e in (jeng, teng):
        e.max_new_tokens = MAX_NEW
    return jeng, teng


def _states(jeng, teng, kind):
    kv_quant, layout, cls = KINDS[kind]
    for e in (jeng, teng):
        e.kv_quant, e.flat_decode = kv_quant, layout
    jst = jeng.prefill(CTX, prefill_chunk_size=300, do_score=False)
    tst = teng.prefill(CTX, prefill_chunk_size=300, do_score=False)
    if kind != "dense":
        cfg = teng.config
        score = np.random.default_rng(7).random(
            (cfg.num_layers, cfg.num_kv_heads, tst.ctx_len)).astype(np.float32)
        jst.score, tst.score = jnp.asarray(score), torch.from_numpy(score)
        jeng.prune(jst, 0.3, "pair")
        teng.prune(tst, 0.3, "pair")
    assert isinstance(tst.cache, cls)
    return jst, tst


def _same_counters(jst, tst):
    jc, tc = jst.cache, tst.cache
    assert int(tc.seen) == int(jc.seen)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    if hasattr(jc, "tail_len"):
        assert int(tc.tail_len) == int(jc.tail_len)
        assert tc.tail_lens.tolist() == [int(jc.tail_len)] * tc.k_tail.shape[1]


def _ids(text):
    return [int(t) for t in text.split()]


@pytest.mark.parametrize("kind", list(KINDS))
def test_step_loop_matches_reference(engines, kind):
    jeng, teng = engines
    jst, tst = _states(jeng, teng, kind)
    eos = (jeng.eos_ids, teng.eos_ids)
    try:
        for update in (False, True):
            want = jeng.generate(QUERY, jst, update_cache=update)
            assert teng.generate(QUERY, tst, update_cache=update) == want
            _same_counters(jst, tst)
        # an eos the next answer emits, inside the first chunk of steps
        ans = _ids(jeng.generate(QUERY, jst))
        k = next(i for i in range(2, len(ans)) if ans[i] not in ans[:i])
        assert 0 < k < DECODE_CHUNK
        jeng.eos_ids = teng.eos_ids = (ans[k],)
        for update in (False, True):
            want = jeng.generate(QUERY, jst, update_cache=update)
            got = teng.generate(QUERY, tst, update_cache=update)
            assert got == want and len(_ids(got)) < MAX_NEW
            _same_counters(jst, tst)
    finally:
        jeng.eos_ids, teng.eos_ids = eos


def test_multi_turn_refold_matches_reference(engines):
    jeng, teng = engines
    jst, tst = _states(jeng, teng, "pool")
    turn = 0
    while tst.refolds == 0:
        q = f"Turn {turn}: and then?"
        assert teng.generate(q, tst, update_cache=True) == jeng.generate(q, jst,
                                                                         update_cache=True)
        _same_counters(jst, tst)
        turn += 1
        assert turn < 12, "no refold"
    assert not tst._steps or all(s.cache is tst.cache for s in tst._steps.values())
    assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)
    _same_counters(jst, tst)


@pytest.mark.parametrize("kind", ["pool", "dense"])
def test_restore_keeps_counter_tensors(engines, kind):
    jeng, teng = engines
    _, tst = _states(jeng, teng, kind)
    c = tst.cache
    names = ("seen", "lengths", "tail_lens") if kind == "pool" else ("seen", "lengths")
    before = {n: getattr(c, n) for n in names}
    seen0 = int(c.seen)
    teng.generate_ids(QUERY, tst)
    teng.generate_ids(QUERY, tst, update_cache=True)
    tst.restore_snapshot()
    assert all(getattr(c, n) is t for n, t in before.items())
    assert int(c.seen) > seen0
    if kind == "pool":
        assert c.tail_len.data_ptr() == c.tail_lens.data_ptr() and int(c.tail_len) > 0


@pytest.mark.parametrize("eos_mid", [False, True])
@pytest.mark.parametrize("kind", ["pool", "flat", "dense"])
def test_launch_counts_equal_the_per_token_loops(engines, kind, eos_mid, monkeypatch):
    """Each plain attention call of the path stands in for a launch; the
    captured loop's counts (the step's counts once a step that advanced)
    equal the per-token loop's, and so do its tokens and counters."""
    jeng, teng = engines
    _, tst = _states(jeng, teng, kind)
    name = {"pool": "pool_decode_attend", "flat": "flat_decode_attend",
            "dense": "ragged_decode_attend"}[kind]
    real = getattr(transformer, name)

    def counted(*args, **kw):
        LAUNCHES[name] += 1
        return real(*args, **kw)

    monkeypatch.setattr(transformer, name, counted)
    eos = teng.eos_ids
    try:
        if eos_mid:
            ans = teng.generate_ids(QUERY, tst).tolist()
            teng.eos_ids = (next(t for i, t in enumerate(ans) if i >= 2 and t not in ans[:i]),)
        snap, prefill_ids = snapshot(tst.cache), tst.prefill_ids
        runs = []
        for fn in (engine_lib.Engine.generate_ids, generate_ids_per_token):
            reset_launches()
            toks = fn(teng, QUERY, tst, update_cache=True)
            runs.append((toks.tolist(), dict(LAUNCHES), int(tst.cache.seen),
                         tst.cache.lengths.tolist(), int(getattr(tst.cache, "tail_len", 0))))
            restore(tst.cache, snap)
            tst.prefill_ids = prefill_ids
            tst.snapshot()
    finally:
        teng.eos_ids = eos
    (t1, l1, *c1), (t2, l2, *c2) = runs
    assert t1 == t2 and c1 == c2 and l1 == l2 and l1[name] > 0
    assert (len(t1) < MAX_NEW) == eos_mid


@pytest.mark.parametrize("kind", ["pool", "flat"])
def test_tail_room_is_checked_before_forwarding(engines, kind):
    """``forward`` reads nothing back, so the engine's one check stands
    between a call and the tail's end: a plain forward or a generate that
    needs more rows than the tail holds raises before anything is written."""
    jeng, teng = engines
    _, tst = _states(jeng, teng, kind)
    cap = tst.cache.k_tail.shape[2]
    seen0 = int(tst.cache.seen)
    with pytest.raises(ValueError, match="tail rows"):
        teng.forward_ids(np.ones(cap + 1, np.int32), tst)
    with pytest.raises(ValueError, match="tail rows"):
        teng.generate_ids(QUERY, tst, max_new_tokens=cap)
    assert int(tst.cache.seen) == seen0 and int(tst.cache.tail_len) == 0
