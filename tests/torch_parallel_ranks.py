"""Rank programs of the port's parallel tests (``tests/test_torch_parallel*.py``).

Each function runs in every rank of a gloo group that
``kvzip_tpu_torch.parallel.dryrun.spawn`` starts (one process a rank, one
torch thread), takes what the test process made with the reference (a
config, the weights as port tensors, token ids) and returns numpy arrays
and token ids for the test process to hold against the reference. This
module imports no ``jax`` and nothing of ``kvzip_tpu`` (each program
checks that its rank has not loaded them); it is not collected.
"""

from __future__ import annotations

import copy
import os
import sys
import tempfile
import warnings

import numpy as np
import torch


def _no_reference() -> None:
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "kvzip_tpu")]
    if bad:
        raise AssertionError(f"a rank loaded {bad[:3]}")


def _engine(cfg, params, mesh=None, name="tiny-llama", **kw):
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.tokenizer import ByteTokenizer

    base = dict(kv_type="evict", max_new_tokens=8, decode_budget=256,
                capacity_granularity=256, score_chunk_size=256)
    return Engine(name, config=cfg, params=params, dtype=torch.float32, device="cpu",
                  tokenizer=ByteTokenizer(cfg.vocab_size), mesh=mesh, **{**base, **kw})


def _heads(eng) -> tuple:
    from kvzip_tpu_torch.parallel.mesh import shard_of

    sh = shard_of(eng.config, eng.mesh)
    return sh.kv0, sh.Hkv, sh.rep_idx


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ------------------------------------------------- test_torch_parallel.py
def tp_cases(rank: int, world: int, cases: dict) -> dict:
    """The cases of ``test_torch_parallel.py`` in one group of 4 ranks."""
    from kvzip_tpu_torch import prune
    from kvzip_tpu_torch.ops.fused_act import silu_mul_quant_plain
    from kvzip_tpu_torch.ops.quant import quantize_act_int8
    from kvzip_tpu_torch.parallel import collectives as tpc
    from kvzip_tpu_torch.parallel.mesh import make_mesh, shard_geometry, shard_of

    _no_reference()
    out = {}
    mesh4 = make_mesh(tp=4)

    # the engines of test_parallel.py's TP cases: llama, gemma3
    for key in ("llama", "gemma3"):
        c = cases[key]
        kw = c.get("engine", {})
        eng = _engine(c["cfg"], c["params"], mesh4, name=c["name"], **kw)
        st = eng.prefill(c["ctx"], prefill_chunk_size=300)
        r = dict(heads=_heads(eng), score=_np(st.score))
        eng.prune(st, 0.5, "pair")
        r["lengths"] = _np(st.cache.lengths)
        r["pool"] = type(st.cache).__name__
        r["prob"] = eng.prob(c["query"], st)
        r["answer"] = eng.generate_ids(c["query"], st)
        out[key] = r

    # the histogram threshold over head-sharded scores
    c = cases["hist"]
    h = {}
    for name, score, kv in (("pair", c["score"], 8), ("head", c["bcast"], 8),
                            ("shared", c["shared"], 2)):
        sh = shard_geometry(c["cfg"][kv], 4, rank)
        group = tpc.ScoreGroup(mesh4, sh)
        local = torch.from_numpy(score[:, sh.kv0:sh.kv0 + sh.Hkv])
        for ratio in c["ratios"][name]:
            valid, thres = prune.threshold_histogram(local, ratio, group=group)
            h[name, ratio] = (sh.kv0, _np(valid), thres)
    for ratio in c["ratios"]["pair"]:  # the rank guard's fallback, through the group
        sh = shard_geometry(c["cfg"][8], 4, rank)
        local = torch.from_numpy(c["raw"][:, sh.kv0:sh.kv0 + sh.Hkv])
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            valid, thres = prune.threshold_histogram(local, ratio, bins=2, iters=1,
                                                     group=tpc.ScoreGroup(mesh4, sh))
        h["guard", ratio] = (sh.kv0, _np(valid), thres,
                             any("rank guard" in str(x.message) for x in w))
    out["hist"] = h

    # W8A8's row-parallel activations: the whole row's scale, the same bytes
    c = cases["w8"]
    x = torch.from_numpy(c["x"])
    gate, up = torch.from_numpy(c["gate"]), torch.from_numpy(c["up"])
    n = x.shape[1] // 4
    xq, xs = tpc.quantize_act_int8(x[:, rank * n:(rank + 1) * n], mesh4)
    wq, ws = quantize_act_int8(x)
    sh = shard_of(c["cfg"], mesh4)
    I = sh.I
    hq, hs = tpc.silu_mul_quant(gate[:, sh.i0:sh.i0 + I], up[:, sh.i0:sh.i0 + I], "silu",
                                sh, mesh4)
    pq, ps = silu_mul_quant_plain(gate, up, "silu")
    out["w8_act"] = dict(
        bytes_equal=bool(torch.equal(xq, wq[:, rank * n:(rank + 1) * n])),
        scales_equal=bool(torch.equal(xs, ws)),
        k14_bytes_equal=bool(torch.equal(hq, pq[:, sh.i0:sh.i0 + I])),
        k14_scales_equal=bool(torch.equal(hs, ps)),
        local_scale_differs=bool(not torch.equal(
            quantize_act_int8(x[:, rank * n:(rank + 1) * n])[1], ws)))
    # the fused form: K13 and, through the gathered row, K14 (wo's input
    # goes through the row-wide quantize_act_int8 as in the unfused form)
    kw = dict(weight_quant="w8a8", act_fused="pallas", flat_decode="off")
    eng = _engine(c["cfg"], c["params"], mesh4, **kw)
    st = eng.prefill(c["ctx"], prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")
    one = _engine(c["cfg"], c["params"], **kw)
    st1 = one.prefill(c["ctx"], prefill_chunk_size=300)
    one.prune(st1, 0.5, "pair")
    out["w8"] = dict(answer=eng.generate_ids(c["query"], st),
                     single=one.generate_ids(c["query"], st1),
                     prob=eng.prob(c["query"], st), single_prob=one.prob(c["query"], st1))

    # data 2 x model 2: the TP=4 case's context on a data axis of 2
    c = cases["dp_tp"]
    mesh22 = make_mesh(tp=2)
    eng = _engine(c["cfg"], c["params"], mesh22)
    st = eng.prefill(c["ctx"], prefill_chunk_size=300)
    eng.prune(st, 0.5, "pair")
    out["dp_tp"] = dict(answer=eng.generate_ids(c["query"], st), heads=_heads(eng),
                        lengths=_np(st.cache.lengths), data=mesh22.get_local_rank("data"))
    return out


# -------------------------------------------- test_torch_parallel_pool.py
def pool_cases(rank: int, world: int, cases: dict) -> dict:
    """The cases of ``test_torch_parallel_pool.py`` in one group of 4 ranks:
    pool-TP (data 2 x model 2), its guards, and the ring prefill."""
    from kvzip_tpu_torch import serving
    from kvzip_tpu_torch.parallel.mesh import make_mesh
    from kvzip_tpu_torch.parallel.ring_prefill import reshard_to_cache, ring_prefill
    from kvzip_tpu_torch.pool import PoolInt4KV, PoolKV

    _no_reference()
    out = {}
    mesh22 = make_mesh(tp=2)
    c = cases["pool"]
    for kv_quant in ("none", "int4"):
        eng = _engine(c["cfg"], c["params"], mesh22, flat_decode="on", kv_quant=kv_quant,
                      max_new_tokens=6)
        scored = eng.prefill(c["ctx"], prefill_chunk_size=200)
        for level in ("pair", "head"):
            st = copy.deepcopy(scored)
            r = dict(heads=_heads(eng), score=_np(st.score))
            if level == "head":
                kv0, hkv, _ = _heads(eng)
                hs = c["head_scores"][:, kv0:kv0 + hkv]
                st.score = torch.from_numpy(np.ascontiguousarray(
                    np.broadcast_to(hs[:, :, None], (*hs.shape, st.ctx_len))))
            eng.prune(st, 0.5, level)
            pool = st.cache
            r.update(kind=type(pool).__name__, tp=pool.tp, lengths=_np(pool.lengths),
                     is_pool=isinstance(pool, (PoolKV, PoolInt4KV)),
                     answer=eng.generate_ids(c["query"], st))
            out["pool", kv_quant, level] = r
            if (kv_quant, level) == ("none", "pair"):
                eng_pool, st_pool = eng, st

    # the guards: refold, save_state, the merged pool, stacking a pool batch
    eng, st = eng_pool, st_pool
    guards = {}
    for name, call in (
            ("refold", lambda: eng._maybe_refold(st, st.cache.k_tail.shape[2] + 1, 0)),
            ("save_state", lambda: eng.save_state(st, os.path.join(tempfile.mkdtemp(), "s"))),
            ("merge_pool", lambda: serving._merge_pool([st.cache, st.cache])),
            ("batched", lambda: serving.batched_generate_ids(eng, [c["query"]] * 2, [st, st]))):
        try:
            call()
            guards[name] = None
        except Exception as e:  # the test matches the type and message
            guards[name] = (type(e).__name__, str(e))
    out["guards"] = guards

    # the ring: its K/V against the sequential prefill (data 4, model 1)
    c = cases["ring"]
    mesh4 = make_mesh(tp=1)
    eng = _engine(c["cfg"], c["params"], mesh4, kv_type="retain", max_new_tokens=4)
    k, v = ring_prefill(eng.params, c["cfg"], c["full"], mesh4)
    out["ring_kv"] = dict(k=_np(k), v=_np(v), data=mesh4.get_local_rank("data"))

    # Engine(seq_parallel=True) through the whole pipeline (data 2 x model 2)
    eng2 = _engine(c["cfg"], c["params"], mesh22, kv_type="retain", max_new_tokens=4,
                   seq_parallel=True)
    st2 = eng2.prefill(c["ctx517"], prefill_chunk_size=256)
    r = dict(heads=_heads(eng2), score=_np(st2.score))
    eng2.prune(st2, 0.5, "pair")
    r["answer"] = eng2.generate_ids(c["query"], st2, max_new_tokens=4)
    out["seq_parallel"] = r

    # ring KV resharded into a TP engine's cache, then decoded
    eng3 = _engine(c["cfg"], c["params"], mesh22, kv_type="retain", max_new_tokens=4)
    st3 = eng3.prefill(c["ctx"], prefill_chunk_size=256, do_score=False)
    k, v = ring_prefill(eng3.params, c["cfg"], c["full"], mesh22)
    reshard_to_cache(k, v, mesh22, st3.cache)
    st3.snapshot()
    out["reshard"] = dict(prob=eng3.prob(c["q24"], st3))
    return out


# ----------------------------------------- test_torch_parallel_serving.py
def serving_cases(rank: int, world: int, cases: dict) -> dict:
    """The replica mesh (replica 2 x model 2) and its batched serving, then
    the dry run's four legs, in one group of 4 ranks."""
    from kvzip_tpu_torch.parallel.dryrun import legs
    from kvzip_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from kvzip_tpu_torch.serving import batched_generate_ids

    _no_reference()
    c = cases["replica"]
    mesh = make_mesh(tp=2, replicas=2)
    eng = _engine(c["cfg"], c["params"], mesh, flat_decode="off", max_new_tokens=6)
    st = eng.prefill(c["ctx"], prefill_chunk_size=300)
    out = dict(axes=mesh.mesh_dim_names, shape=mesh_shape(mesh), heads=_heads(eng),
               score=_np(st.score))
    eng.prune(st, 0.5, "pair")
    out["prob"] = eng.prob(c["query"], st)
    states = [eng.prefill(x, prefill_chunk_size=300) for x in c["ctxs"]]
    for s in states:
        eng.prune(s, 0.5, "pair")
    # four requests over two states (nothing is written back, so a state
    # may serve several requests of a batch)
    out["batched"] = batched_generate_ids(eng, [c["query"]] * 4, states * 2, max_new_tokens=5)
    out["legs"] = legs(rank, world, repeat=6)
    return out


def cli_ranks(rank: int, world: int, workdir: str, argv: list) -> dict:
    """``kvzip_tpu_torch.cli.main(argv)`` on this rank of the spawned gloo
    group (the environment torchrun would give: WORLD_SIZE, RANK,
    KVZIP_PLATFORM=cpu), CPU-sized engines (float32, the byte tokenizer,
    small scoring windows); returns what it printed."""
    import contextlib
    import io

    from kvzip_tpu_torch import cli
    from kvzip_tpu_torch import engine as engine_module
    from kvzip_tpu_torch.tokenizer import ByteTokenizer

    _no_reference()
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      KVZIP_PLATFORM="cpu", HF_DATASETS_OFFLINE="1", HF_HUB_OFFLINE="1")
    real = engine_module.Engine

    class Small(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**dict(score_chunk_size=256, capacity_granularity=256,
                                           max_new_tokens=16, decode_budget=160,
                                           tokenizer=ByteTokenizer(512)), **kw})

    engine_module.Engine = Small
    os.chdir(workdir)
    buf = io.StringIO()
    stdout = sys.stdout
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
            silenced = sys.stdout is not buf  # rank > 0 swapped in devnull
    finally:
        sys.stdout = stdout
    return dict(out=buf.getvalue(), silenced=silenced)
