"""Serving's dense batch path (``kvzip_tpu_torch/serving.py``:
``_merge_dense``, the masked route over B·Hkv heads, one decode step for
the batch) and mixed cache types in the scheduler, against
``kvzip_tpu/serving.py``, float32 on the CPU, one reference engine for the
module.

The reference prefills three contexts (no scoring pass: scores from a
seed); each dense cache is carried into a port state and both prune with
the same scores, as a retain state (pair 0.4-0.6), a compacted one
(``flat_decode="off"``) or not at all. Tolerances: the tokens of
``batched_generate``, ``_decode_segment`` and ``Scheduler.run`` /
``run_continuous`` equal the reference's and each state's own
``generate``; a segment leaves each state's lengths and positions where
the reference's are, in the same tensors, and its live K/V rows within
1e-5 of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import serving as jserving
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu_torch import serving
from kvzip_tpu_torch.cache import KVCache
from kvzip_tpu_torch.engine import KVState

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_retain import KW, SHAPE, IdTokenizer, _tree, port_engine
from test_torch_serving import CTXS, QUERIES, _carry_dense

RATIOS = (0.4, 0.5, 0.6)


@pytest.fixture(scope="module")
def engines():
    tree = _tree(SHAPE)
    jeng = JEngine("tiny-llama", config=tiny_config("llama", **SHAPE),
                   params=jax.tree_util.tree_map(jnp.asarray, tree),
                   tokenizer=IdTokenizer(512), dtype=jnp.float32, flat_decode="off", **KW)
    return jeng, tree, {}


def _states(engines, kind):
    """(reference states, port states, port engine) of a kind: "retain"
    (pruned retain states), "compact" (evict, ``flat_decode="off"``) or
    "unpruned" (evict, never pruned); made once a module."""
    jeng, tree, made = engines
    if kind not in made:
        kv_type = "retain" if kind == "retain" else "evict"
        teng = port_engine(tree, kv_type=kv_type, flat_decode="off")
        jeng.kv_type = kv_type
        jsts, tsts = [], []
        for i, (ctx, r) in enumerate(zip(CTXS, RATIOS)):
            jst = jeng.prefill(ctx, prefill_chunk_size=256, do_score=False)
            tst = KVState(cache=_carry_dense(jst.cache), kv_type=kv_type, sink=jst.sink,
                          ctx_len=jst.ctx_len, prefill_len=jst.prefill_len,
                          prefill_ids=np.asarray(jst.prefill_ids),
                          ctx_ids=np.asarray(jst.ctx_ids))
            tst.snapshot()
            if kind != "unpruned":
                score = np.random.default_rng(i).random(
                    (SHAPE["num_layers"], SHAPE["num_kv_heads"], jst.ctx_len)).astype(np.float32)
                jst.score, tst.score = jnp.asarray(score), torch.from_numpy(score)
                jeng.prune(jst, r, "pair")
                teng.prune(tst, r, "pair")
            assert isinstance(tst.cache, KVCache)
            jsts.append(jst)
            tsts.append(tst)
        jeng.kv_type = "evict"
        made[kind] = (jsts, tsts, teng)
    return made[kind]


@pytest.mark.parametrize("kind", ["retain", "compact", "unpruned"])
def test_dense_batch_matches_reference_and_singles(engines, kind):
    jeng = engines[0]
    jsts, tsts, teng = _states(engines, kind)
    single = [teng.generate(q, st) for q, st in zip(QUERIES, tsts)]
    snaps = [(st.cache.lengths.clone(), st.cache.seen.clone()) for st in tsts]
    assert serving.batched_generate(teng, QUERIES, tsts) == single
    assert jserving.batched_generate(jeng, QUERIES, jsts,
                                     max_new_tokens=KW["max_new_tokens"]) == single
    for st, (lens, seen) in zip(tsts, snaps):  # the merged cache was a copy
        assert torch.equal(st.cache.lengths, lens) and torch.equal(st.cache.seen, seen)
    sched = serving.Scheduler(teng)
    for q, st in zip(QUERIES, tsts):
        sched.submit(q, st)
    assert sched.run() == single
    with pytest.raises(ValueError, match="capacity"):
        serving.batched_generate(teng, QUERIES, tsts, max_new_tokens=tsts[0].cache.capacity)


@pytest.mark.parametrize("kind", ["retain", "compact"])
def test_dense_segment_and_continuous_match_reference(engines, kind):
    """A segment of 5 steps after each state's first query token, written
    back in place; then continuous batching over the three states."""
    jeng = engines[0]
    jsts, tsts, teng = _states(engines, kind)
    last = [int(q[-1]) for q in QUERIES]
    for st in (*jsts, *tsts):
        st.snapshot()
    lens = [st.cache.lengths for st in tsts]
    got = serving._decode_segment(teng, tsts, last, 5)
    want = jserving._decode_segment(jeng, jsts, last, 5)
    np.testing.assert_array_equal(got, np.asarray(want))
    for st, jst, t in zip(tsts, jsts, lens):
        assert st.cache.lengths is t
        np.testing.assert_array_equal(t.numpy(), np.asarray(jst.cache.lengths))
        assert int(st.cache.seen) == int(jst.cache.seen) == st.prefill_len + 5
        live = (torch.arange(st.cache.capacity) < t[..., None]).numpy()
        for f in ("k", "v"):  # the rows the segment wrote, copied back
            np.testing.assert_allclose(getattr(st.cache, f).numpy()[live],
                                       np.asarray(getattr(jst.cache, f))[live],
                                       rtol=1e-5, atol=1e-5)
    for st in (*jsts, *tsts):
        st.restore_snapshot()
    single = [teng.generate(q, st) for q, st in zip(QUERIES, tsts)]
    sched = serving.Scheduler(teng, max_batch=2)
    for q, st in zip(QUERIES, tsts):
        sched.submit(q, st)
    assert sched.run_continuous(segment=3) == single
    assert all(int(st.cache.seen) == st.prefill_len for st in tsts)


def test_scheduler_mixed_cache_types(engines):
    """A retain state between two flat states in one queue (the reference's
    ``tests/test_serving.py::test_scheduler_mixed_cache_types``): grouped
    by cache type, each answer its own state's, in request order, in both
    packages; continuously batched too (the port)."""
    jeng, tree, _ = engines
    jsts_r, tsts_r, teng_r = _states(engines, "retain")
    teng_e = port_engine(tree, flat_decode="legacy")
    jeng.flat_decode = "legacy"
    try:
        flat = []
        for ctx in CTXS[:2]:
            jst = jeng.prefill(ctx, prefill_chunk_size=256)
            tst = teng_e.prefill(ctx, prefill_chunk_size=256, do_score=False)
            tst.score = torch.from_numpy(np.array(jst.score))
            jeng.prune(jst, 0.5, "pair")
            teng_e.prune(tst, 0.5, "pair")
            flat.append((jst, tst))
        q = QUERIES[0]
        want = [teng_e.generate(q, flat[0][1]), teng_r.generate(q, tsts_r[0]),
                teng_e.generate(q, flat[1][1])]
        outs = []
        for sched_cls, eng, order in (
                (serving.Scheduler, teng_e, (flat[0][1], tsts_r[0], flat[1][1])),
                (jserving.Scheduler, jeng, (flat[0][0], jsts_r[0], flat[1][0]))):
            sched = sched_cls(eng, max_batch=4)
            for st in order:
                sched.submit(q, st)
            outs.append(sched.run())
        assert outs[0] == outs[1] == want
        sched = serving.Scheduler(teng_e, max_batch=4)
        for st in (flat[0][1], tsts_r[0], flat[1][1], tsts_r[1]):
            sched.submit(q, st)
        assert sched.run_continuous(segment=2) == want + [teng_r.generate(q, tsts_r[1])]
    finally:
        jeng.flat_decode = "off"
