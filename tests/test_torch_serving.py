"""The port's batched serving (``kvzip_tpu_torch/serving.py``) against the
reference's (``kvzip_tpu/serving.py``), in float32 on the CPU.

One reference engine for the module, its weights carried across by
``params_from_jax``; for the quantized cases (int4 KV, W4A8, int8
embedding) the same engine is given the reference's prepared W4A8 tree.
Each case prefills three contexts in the reference (no scoring pass:
scores drawn from a seed), carries each dense cache into a port state and
prunes both at ratios 0.4, 0.5 and 0.6 with the same scores, so that both
packages hold the same pools (or flat caches) and the rows merge
identically.

Tolerances: merged live rows (K transposed back from the reference's
layout), scales and zeros equal to 1e-6; merged ``layer_rows``, live
``row_head`` ids, tail lengths and positions equal; tokens of
``batched_generate``, ``Scheduler.run`` and ``Scheduler.run_continuous``
(also with several queries on one state) equal to the reference's and to
each state's own port ``generate``; the
int8-attention mode, a fused v1 W4A8 tree and W8A8 weights held against
the port's own single-state answers (the reference ignores
``attn_quant`` on the CPU; on the merged pool the int8 mode's 64-row p
tiles group other rows than a single pool's, the requests' rows lying
back to back, so its answers equal the single-state ones on these inputs,
not by construction); ``batched_logits`` within 1e-4 of each state's own
``forward_ids`` logits, one token a forward or the queries in one pass
first (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import serving as jserving
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch import serving
from kvzip_tpu_torch.cache import FlatInt4KV, FlatKV, Int4KVCache, KVCache
from kvzip_tpu_torch.engine import Engine, KVState
from kvzip_tpu_torch.models.params import init_params_w4a8, params_from_jax
from kvzip_tpu_torch.ops.w4a8 import fuse_w4a8_params
from kvzip_tpu_torch.pool import PoolInt4KV, PoolKV, synthetic_full_pool

from test_torch_engine import IdTokenizer, one_torch_thread  # noqa: F401

SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2)
KW = dict(max_new_tokens=4, decode_budget=132, capacity_granularity=256,
          score_chunk_size=256)
QUANT = dict(kv_quant="int4", weight_quant="w4a8", embed_quant="int8")
RATIOS = (0.4, 0.5, 0.6)
# kind -> (quantized, the prune's layout, the port's cache class)
KINDS = {"pool": (False, "on", PoolKV), "flat": (False, "legacy", FlatKV),
         "int4_pool": (True, "on", PoolInt4KV), "int4_flat": (True, "legacy", FlatInt4KV)}
rng = np.random.default_rng(11)
CTXS = [rng.integers(3, 512, n).astype(np.int32) for n in (200, 180, 190)]
QUERIES = [rng.integers(3, 512, n).astype(np.int32) for n in (9, 16, 12)]


@pytest.fixture(scope="module")
def engines():
    """The reference engine, its float and W4A8 trees, and the port's float
    and quantized engines on the same weights."""
    jcfg = tiny_config("llama", **SHAPE)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    # weights at 7x the init scale, as in test_torch_engine.py
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][name] = tree["layers"][name] * np.float32(7.0)
    jeng = JEngine("tiny-llama", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   tokenizer=IdTokenizer(512), dtype=jnp.float32, **KW)
    qtree, _ = jparams.prepare_params(jcfg, "tiny-llama", dtype=jnp.float32,
                                      weight_quant="w4a8", embed_quant="int8", params=tree)
    port = {}
    for quant, t in ((False, tree), (True, jax.device_get(qtree))):
        port[quant] = Engine("tiny-llama", config=tconfig.tiny_config("llama", **SHAPE),
                             params=params_from_jax(t, "cpu", torch.float32),
                             tokenizer=IdTokenizer(512), dtype=torch.float32, device="cpu",
                             **KW, **(QUANT if quant else {}))
    return jeng, {False: jeng.params, True: qtree}, port


def _use(jeng, jtrees, teng, quant: bool, layout: str) -> None:
    jeng.params = jtrees[quant]
    jeng.kv_quant = "int4" if quant else "none"
    jeng.flat_decode = teng.flat_decode = layout


def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rows(a) -> torch.Tensor:
    """The reference's transposed (..., W, C) rows as (..., C, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(a), -1, -2)))


def _carry_dense(jc):
    if hasattr(jc, "k_q"):
        return Int4KVCache(k_q=_rows(jc.k_q), v_q=_rows(jc.v_q), k_s=_np(jc.k_s)[..., 0],
                           k_z=_np(jc.k_z)[..., 0], v_s=_np(jc.v_s)[..., 0],
                           v_z=_np(jc.v_z)[..., 0], lengths=_np(jc.lengths), seen=int(jc.seen))
    return KVCache(k=_np(jc.k), v=_np(jc.v), lengths=_np(jc.lengths), seen=int(jc.seen))


def _pruned(engines, kind, n=3):
    """n contexts prefilled by the reference, carried into the port, both
    pruned at RATIOS with the same scores: (reference states, port
    states)."""
    jeng, jtrees, port = engines
    quant, layout, cls = KINDS[kind]
    teng = port[quant]
    _use(jeng, jtrees, teng, quant, layout)
    cfg = teng.config
    jsts, tsts = [], []
    for i, (ctx, r) in enumerate(zip(CTXS[:n], RATIOS)):
        jst = jeng.prefill(ctx, prefill_chunk_size=256, do_score=False)
        score = np.random.default_rng(i).random(
            (cfg.num_layers, cfg.num_kv_heads, jst.ctx_len)).astype(np.float32)
        tst = KVState(cache=_carry_dense(jst.cache), kv_type="evict", sink=jst.sink,
                      ctx_len=jst.ctx_len, prefill_len=jst.prefill_len,
                      prefill_ids=np.asarray(jst.prefill_ids), ctx_ids=np.asarray(jst.ctx_ids))
        jst.score, tst.score = jnp.asarray(score), torch.from_numpy(score)
        jeng.prune(jst, r, "pair")
        teng.prune(tst, r, "pair")
        assert isinstance(tst.cache, cls)
        jsts.append(jst)
        tsts.append(tst)
    return jsts, tsts


_STATES = {}


@pytest.fixture
def states(engines, request):
    """The three pruned states of a kind, made once a module."""
    kind = request.param
    if kind not in _STATES:
        _STATES[kind] = _pruned(engines, kind)
    jeng, jtrees, port = engines
    quant, layout, _ = KINDS[kind]
    _use(jeng, jtrees, port[quant], quant, layout)
    return (kind, port[quant], *_STATES[kind])


def _live(rows, row_head, heads):
    """{head: its live rows in order} of one layer's rows (n, ...)."""
    return {h: rows[row_head == h] for h in heads}


def _same_live(got_rows, got_rh, want_rows, want_rh, heads, what):
    got, want = _live(got_rows, got_rh, heads), _live(want_rows, want_rh, heads)
    for h in heads:
        assert got[h].shape == want[h].shape and got[h].shape[0] > 0, (what, h)
        np.testing.assert_allclose(got[h].double().numpy(), want[h].double().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{what} head {h}")


@pytest.mark.parametrize("states", list(KINDS), indirect=True)
def test_merge_matches_reference(states):
    """For each (layer, merged kv head), the live K/V rows (scales and
    zeros) in order are the reference's; ``layer_rows``, live ``row_head``
    ids, tails, tail lengths and positions equal; segments start on
    multiples of ``align``."""
    kind, _, jsts, tsts = states
    pool = kind.endswith("pool")
    int4 = kind.startswith("int4")
    got = (serving._merge_pool if pool else serving._merge_flat)([s.cache for s in tsts])
    want = (jserving._merge_pool if pool else jserving._merge_flat)([s.cache for s in jsts])
    L, B, Hkv = got.k_tail.shape[0], len(tsts), SHAPE["num_kv_heads"]
    heads = range(B * Hkv)
    # the reference's merged context arrays, K-type ones transposed back
    names = (("k_flat_q", "v_flat_q", "k_flat_s", "k_flat_z", "v_flat_s", "v_flat_z")
             if int4 else ("k_flat", "v_flat"))
    ref = {n: (_rows(want[n]) if n in ("k_flat", "k_flat_q", "v_flat_q")
               else _np(want[n])[0] if pool and n != "v_flat" else _np(want[n]))
           for n in names}
    mine = ({n: getattr(got, n.replace("flat", "pool")) for n in names} if pool
            else {n: getattr(got, n) for n in names})
    if pool:
        np.testing.assert_array_equal(got.layer_rows.numpy(), np.asarray(want["layer_rows"]))
        rows = got.layer_rows.numpy()
        assert got.align == 64 and got.max_rows == int((-(-rows // 64) * 64).max())
        j_rh = _np(want["row_head"])[0]
        for l in range(L):
            o, jo = int(got.layer_off[l]), int(want["layer_off"][l])
            assert o % got.align == 0 and jo % want["align"] == 0
            n = int(got.layer_rows[l])
            seg, jseg = slice(o, o + n), slice(jo, jo + n)
            assert torch.equal(got.row_head[seg], j_rh[jseg]) and (got.row_head[seg] >= 0).all()
            for f in names:
                _same_live(mine[f][seg], got.row_head[seg], ref[f][jseg], j_rh[jseg], heads,
                           f"layer {l} {f}")
    else:
        j_rh = _np(want["row_head"])
        assert torch.equal(got.row_head, j_rh)
        R = got.row_head.shape[1] // B
        live = (got.row_head >= 0).reshape(L, B, R).sum(-1).to(torch.int32)
        assert torch.equal(got.seg_rows, live)
        for l in range(L):
            for f in names:
                _same_live(mine[f][l], got.row_head[l], ref[f][l], j_rh[l], heads,
                           f"layer {l} {f}")
    np.testing.assert_array_equal(got.k_tail.numpy(), np.asarray(want["k_tail"]))
    np.testing.assert_array_equal(got.tail_lens.numpy(), np.asarray(want["tail_lens"]))
    np.testing.assert_array_equal(got.seen.numpy(), np.asarray(want["seen"]))


@pytest.mark.parametrize("states", list(KINDS), indirect=True)
def test_batched_generate_matches_reference(engines, states):
    """The same tokens as the reference's batched_generate and as each
    state's own generate; every state restored (tail and position)."""
    jeng = engines[0]
    _, teng, jsts, tsts = states
    single = [teng.generate(q, st) for q, st in zip(QUERIES, tsts)]
    got = serving.batched_generate(teng, QUERIES, tsts)
    assert got == single
    assert got == jserving.batched_generate(jeng, QUERIES, jsts,
                                            max_new_tokens=KW["max_new_tokens"])
    for st in tsts:
        assert int(st.cache.tail_len) == 0 and (st.cache.tail_lens == 0).all()
        assert int(st.cache.seen) == st.prefill_len


@pytest.mark.parametrize("states", ["int4_pool", "int4_flat"], indirect=True)
def test_batched_generate_int8_attention(states):
    """attn_quant="int8" (K7-q8 / K11-q8 on the card): the merged tokens
    equal each state's own single-state q8 answer."""
    _, teng, _, tsts = states
    teng.attn_quant = "int8"
    try:
        single = [teng.generate(q, st) for q, st in zip(QUERIES, tsts)]
        assert serving.batched_generate(teng, QUERIES, tsts) == single
    finally:
        teng.attn_quant = "none"


@pytest.mark.parametrize("states", ["pool"], indirect=True)
def test_batched_generate_other_weights(states):
    """A fused v1 W4A8 tree (K15 on the card) and W8A8 weights through the
    merged stack: each state's own answer; an unfused v1 tree raises."""
    _, teng, _, tsts = states
    cfg = teng.config
    v1 = init_params_w4a8(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    fused = dict(v1, layers=fuse_w4a8_params(v1["layers"]))
    for params, wq in ((fused, "none"), (teng.params, "w8a8")):
        eng = Engine("tiny-llama", config=cfg, params=params, tokenizer=teng.tokenizer,
                     dtype=torch.float32, device="cpu", weight_quant=wq, **KW)
        single = [eng.generate(q, st) for q, st in zip(QUERIES, tsts)]
        assert serving.batched_generate(eng, QUERIES, tsts) == single
    eng = Engine("tiny-llama", config=cfg, params=v1, tokenizer=teng.tokenizer,
                 dtype=torch.float32, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="unfused"):
        serving.batched_generate(eng, QUERIES, tsts)


@pytest.mark.parametrize("states", ["pool"], indirect=True)
@pytest.mark.parametrize("ingest", ["zeros", "queries"])
def test_batched_logits_match_single_forward(states, ingest):
    """One token a forward, or the queries in one padded pass and the rest
    a token a forward (``ingest``): each sequence's merged logits are its
    state's own forward_ids logits."""
    _, teng, _, tsts = states
    seqs = [np.concatenate([q, q[:5]]) for q in QUERIES]
    lens = {"zeros": [0] * 3, "queries": [len(q) for q in QUERIES]}[ingest]
    got = serving.batched_logits(teng, seqs, tsts, ingest=lens)
    for g, s, st in zip(got, seqs, tsts):
        np.testing.assert_allclose(g, teng.forward_ids(s, st, return_logits=True),
                                   rtol=1e-4, atol=1e-4)
        assert int(st.cache.tail_len) == 0


@pytest.mark.parametrize("states", ["pool"], indirect=True)
def test_scheduler_matches_reference(engines, states):
    """run and run_continuous (max_batch 2, four requests on three states,
    segment 2): the reference Scheduler's outputs; the continuous run admits
    mid-flight and keeps a batch across rounds whose members did not
    change; every state restored."""
    jeng = engines[0]
    _, teng, jsts, tsts = states
    reqs = [(0, 2), (1, 4), (2, 3), (0, 4)]  # (state, max_new_tokens)
    outs = []
    for sched_cls, eng, sts in ((serving.Scheduler, teng, tsts),
                                (jserving.Scheduler, jeng, jsts)):
        got = []
        for mode in ("run", "run_continuous"):
            sched = sched_cls(eng, max_batch=2)
            for i, (s, mn) in enumerate(reqs):
                sched.submit(QUERIES[i % 3], sts[s], max_new_tokens=mn)
            got.append(sched.run() if mode == "run" else sched.run_continuous(segment=2))
            if sched_cls is serving.Scheduler and mode == "run_continuous":
                rounds = sched.rounds
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][1] == [teng.generate(QUERIES[i % 3], tsts[s], max_new_tokens=mn)
                          for i, (s, mn) in enumerate(reqs)]
    assert any(r["admitted"] for r in rounds[1:])
    assert any(r["capture_s"] is None for r in rounds)
    for st in tsts:
        assert int(st.cache.tail_len) == 0 and int(st.cache.seen) == st.prefill_len


@pytest.mark.parametrize("states", ["pool", "flat"], indirect=True)
def test_segment_writes_back_in_place(states):
    """After a merged segment each state's tail and counters are its own
    tensors (same storage), advanced by the segment; after the restore the
    state's next generate_ids (through its own decode step, captured
    before the batch) is its answer from before."""
    _, teng, _, tsts = states
    before = [teng.generate_ids(q, st) for q, st in zip(QUERIES, tsts)]
    ptrs = [(st.cache.k_tail.data_ptr(), st.cache.v_tail.data_ptr(),
             st.cache.tail_lens.data_ptr(), st.cache.seen.data_ptr()) for st in tsts]
    for st in tsts:
        st.snapshot()
    toks = serving._decode_segment(teng, tsts, [5, 6, 7], 3)
    assert toks.shape == (3, 3)
    for st, p in zip(tsts, ptrs):
        c = st.cache
        assert (c.k_tail.data_ptr(), c.v_tail.data_ptr(), c.tail_lens.data_ptr(),
                c.seen.data_ptr()) == p
        assert int(c.tail_len) == 3 and (c.tail_lens == 3).all()
        assert int(c.seen) == st.prefill_len + 3
        assert c.tail_len.data_ptr() == c.tail_lens.data_ptr()
        st.restore_snapshot()
    # the segment's tokens are the ones each state decodes alone
    for b, st in enumerate(tsts):
        st.snapshot()
        alone = serving._decode_segment(teng, [st], [5 + b], 3)
        st.restore_snapshot()
        np.testing.assert_array_equal(alone[0], toks[b])
    assert [teng.generate_ids(q, st).tolist() for q, st in zip(QUERIES, tsts)] == \
        [b.tolist() for b in before]


@pytest.mark.parametrize("states", ["pool"], indirect=True)
def test_dense_batch_and_room_check_raise(engines, states):
    """The dense batch path works on unpruned states: batched_generate, a
    segment and a continuous run give each state's own answers (the dense
    route's reference holds are ``test_torch_serving_dense.py``). A batch
    without room raises ValueError in both packages before writing; a
    state twice in a batch that writes back (a segment) raises."""
    jeng = engines[0]
    _, teng, jsts, tsts = states
    dense = teng.prefill(CTXS[0], prefill_chunk_size=256, do_score=False)
    want = [teng.generate(q, dense) for q in QUERIES[:2]]
    assert serving.batched_generate(teng, QUERIES[:2], [dense, dense]) == want
    seen = int(dense.cache.seen)
    dense.snapshot()
    assert serving._decode_segment(teng, [dense], [1], 2).shape == (1, 2)
    assert int(dense.cache.seen) == seen + 2
    dense.restore_snapshot()
    sched = serving.Scheduler(teng)
    sched.submit(QUERIES[0], dense)
    assert sched.run_continuous() == want[:1]
    too_many = KW["decode_budget"]
    with pytest.raises(ValueError, match="capacity"):
        serving.batched_generate(teng, QUERIES, tsts, max_new_tokens=too_many)
    with pytest.raises(ValueError, match="capacity"):
        jserving.batched_generate(jeng, QUERIES, jsts, max_new_tokens=too_many)
    for st in tsts:
        assert int(st.cache.tail_len) == 0
    with pytest.raises(ValueError, match="twice"):
        serving._decode_segment(teng, [tsts[0], tsts[0]], [1, 2], 2)


@pytest.mark.parametrize("states", ["pool", "flat"], indirect=True)
def test_one_state_twice_in_a_batch(engines, states):
    """Several queries on one compressed context in one batch (the merged
    cache is a copy): batched_generate and Scheduler.run give the
    reference's answers and each query's own generate; the state is left
    as it was."""
    jeng = engines[0]
    _, teng, jsts, tsts = states
    want = [teng.generate(q, tsts[0]) for q in QUERIES]
    assert serving.batched_generate(teng, QUERIES[:2], [tsts[0]] * 2) == want[:2]
    assert jserving.batched_generate(jeng, QUERIES[:2], [jsts[0]] * 2,
                                     max_new_tokens=KW["max_new_tokens"]) == want[:2]
    outs = []
    for sched_cls, eng, st in ((serving.Scheduler, teng, tsts[0]),
                               (jserving.Scheduler, jeng, jsts[0])):
        sched = sched_cls(eng)
        for q in QUERIES:
            sched.submit(q, st)
        outs.append(sched.run())
    assert outs[0] == outs[1] == want
    assert int(tsts[0].cache.tail_len) == 0 and int(tsts[0].cache.seen) == tsts[0].prefill_len


def test_stack_dense_caches():
    """_merge_dense puts B dense caches of different capacities side by
    side on the kv-head axis as the reference's ``stack_caches`` stacks
    them (padding rows zero, ``valid`` True), ``seen`` (B,)."""
    from kvzip_tpu.cache import KVCache as JKVCache

    caches, jcaches = [], []
    for C, n in ((256, 100), (512, 300)):
        k = torch.randn(2, 2, C, 128)
        valid = torch.rand(2, 2, C) < 0.7
        lens = torch.full((2, 2), n, dtype=torch.int32)
        caches.append(KVCache(k=k, v=k + 1, lengths=lens, seen=n, valid=valid))
        jcaches.append(JKVCache(k=jnp.asarray(k.numpy()), v=jnp.asarray((k + 1).numpy()),
                                lengths=jnp.asarray(lens.numpy()), seen=jnp.int32(n),
                                valid=jnp.asarray(valid.numpy())))
    got = serving._merge_dense(caches)
    want = jserving.stack_caches(jcaches)
    for f in ("k", "v", "valid", "lengths"):
        w = np.asarray(getattr(want, f))  # (B, L, Hkv, ...) -> (L, B·Hkv, ...)
        w = np.swapaxes(w, 0, 1).reshape(w.shape[1], -1, *w.shape[3:])
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)
    assert got.k.shape == (2, 4, 512, 128) and got.seen.tolist() == [100, 300]


def test_pool_mem_bytes():
    """mem_bytes is the reference's count (``kvzip_tpu/pool.py``: context
    arrays, row_head and both tails) on the port's arrays."""
    cfg = tconfig.tiny_config("llama", **SHAPE)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    for int4 in (False, True):
        p = synthetic_full_pool(L, H, D, 70, 40, torch.bfloat16, "cpu", int4=int4)
        tail = p.k_tail.numel() * p.k_tail.element_size() * 2
        rh = p.row_head.numel() * 4
        if int4:
            ctx = p.k_pool_q.numel() + p.v_pool_q.numel() + 4 * p.k_pool_s.numel() * 4
        else:
            ctx = (p.k_pool.numel() + p.v_pool.numel()) * 2
        P = p.row_head.numel()
        assert P == L * 192  # two 64-row tiles of 70 rows a head, 2 heads
        assert p.mem_bytes() == ctx + rh + tail
        assert p.mem_bytes() == P * (D // 2 * 2 + 16 + 4 if int4 else D * 2 * 2 + 4) + \
            2 * L * H * 40 * D * 2
