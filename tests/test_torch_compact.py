"""The port's dense compaction (``cache.compact``, ``Engine(flat_decode=
"off")``) and the head-level zero-copy eviction against ``kvzip_tpu``,
float32 on the CPU, one reference engine for the module.

Tolerances: compacted lengths equal and rows equal bit for bit (a gather),
bf16 and int4 (the reference's transposed nibbles and (.., 1) scales laid
out as the port's rows); a compacted state's capacity, lengths and greedy
tokens equal the reference's on the same scores. Head level: each head
keeps the whole context or only the sink, the cache stays a dense
``KVCache`` whose live bytes shrink, and the answer equals the retain
path's head-level answer on the same head scores (the reference's
``tests/test_head_score.py::test_head_evict_zero_copy_matches_retain``)
and the reference's own zero-copy answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import cache as jcache
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu_torch import cache as tcache
from kvzip_tpu_torch import prune as tprune

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_retain import CTX_R, KW, QUERY, SHAPE, IdTokenizer, _tree, port_engine


def _rows(a: np.ndarray) -> torch.Tensor:
    """The reference's transposed (..., W, C) rows as (..., C, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, -1, -2)))


@pytest.mark.parametrize("int4", [False, True])
def test_compact_matches_reference(int4):
    """Random caches with ragged lengths and a random keep mask: the same
    lengths and the same rows, zero past each head's length."""
    from kvzip_tpu_torch.ops.quant import quantize_int4

    rng = np.random.default_rng(3)
    L, H, C, D, sink, ctx = 2, 3, 384, 128, 5, 300
    keep = rng.random((L, H, ctx)) < 0.4
    keep[0, 1] = False  # a head that keeps only its sink
    lens = np.full((L, H), sink + ctx, np.int32)
    if int4:
        p = [quantize_int4(torch.from_numpy(rng.standard_normal((L, H, C, D)).astype(np.float32)),
                           pack="split") for _ in range(2)]
        mine = tcache.Int4KVCache(k_q=p[0][0], v_q=p[1][0], k_s=p[0][1][..., 0],
                                  k_z=p[0][2][..., 0], v_s=p[1][1][..., 0], v_z=p[1][2][..., 0],
                                  lengths=torch.from_numpy(lens), seen=sink + ctx)
        ref = jcache.Int4KVCache(
            k_q=jnp.swapaxes(jnp.asarray(p[0][0].numpy()), -1, -2),
            v_q=jnp.swapaxes(jnp.asarray(p[1][0].numpy()), -1, -2),
            k_s=jnp.asarray(p[0][1].numpy()), k_z=jnp.asarray(p[0][2].numpy()),
            v_s=jnp.asarray(p[1][1].numpy()), v_z=jnp.asarray(p[1][2].numpy()),
            lengths=jnp.asarray(lens), seen=jnp.asarray(sink + ctx, jnp.int32),
            valid=jnp.ones((L, H, C), bool))
    else:
        k, v = (rng.standard_normal((L, H, C, D)).astype(np.float32) for _ in range(2))
        mine = tcache.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                              lengths=torch.from_numpy(lens), seen=sink + ctx)
        ref = jcache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lens),
                             seen=jnp.asarray(sink + ctx, jnp.int32),
                             valid=jnp.ones((L, H, C), bool))
    new_cap = 256
    got = tcache.compact(mine, torch.from_numpy(keep), sink, new_cap)
    want = jcache.compact(ref, jnp.asarray(keep), sink, new_cap)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert int(got.lengths[0, 1]) == sink and got.capacity == new_cap and got.valid.all()
    pairs = ((("k_q", True), ("v_q", True), ("k_s", False), ("k_z", False), ("v_s", False),
              ("v_z", False)) if int4 else (("k", False), ("v", False)))
    for f, transposed in pairs:
        w = np.array(getattr(want, f))
        w = _rows(w) if transposed else torch.from_numpy(w.reshape(getattr(got, f).shape))
        assert torch.equal(getattr(got, f), w), f


@pytest.fixture(scope="module")
def engines():
    tree = _tree(SHAPE)
    jeng = JEngine("tiny-llama", config=tiny_config("llama", **SHAPE),
                   params=jax.tree_util.tree_map(jnp.asarray, tree),
                   tokenizer=IdTokenizer(512), dtype=jnp.float32, flat_decode="off", **KW)
    return jeng, port_engine(tree, flat_decode="off"), tree


def test_compacted_state_matches_reference(engines):
    """``flat_decode="off"`` on the same scores: the same capacity, lengths
    and rows, then the same answers (K1/K4's plain versions on a cache
    whose heads' lengths differ)."""
    jeng, teng, _ = engines
    jst = jeng.prefill(CTX_R, prefill_chunk_size=256)
    tst = teng.prefill(CTX_R, prefill_chunk_size=256, do_score=False)
    tst.score = torch.from_numpy(np.array(jst.score))
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    assert tst.cache.capacity == jst.cache.capacity and tst.score is None
    np.testing.assert_array_equal(tst.cache.lengths.numpy(), np.asarray(jst.cache.lengths))
    np.testing.assert_allclose(tst.cache.k.numpy(), np.asarray(jst.cache.k), rtol=1e-4,
                               atol=1e-4)
    assert teng._impl(tst) == "flash" and tst.mem_gb() < 1 and tst.used_gb() >= 0
    for _ in range(2):
        assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)


def test_head_zero_copy_matches_retain(engines, tmp_path):
    """Head scores saved from one scoring (``save_head_score``) and loaded
    (``load_score=True``); a head-level evict prune at 0.6 sets the
    dropped heads' lengths to the sink and moves no row."""
    jeng, teng, tree = engines
    st = teng.prefill(CTX_R, prefill_chunk_size=256)
    tprune.save_head_score(st.score, teng.name, "unit", 0, out_dir=str(tmp_path))
    dirs = [str(tmp_path)]
    ev = teng.prefill(CTX_R, prefill_chunk_size=256, load_score=True, head_score_dirs=dirs)
    reng = port_engine(tree, kv_type="retain")
    rt = reng.prefill(CTX_R, prefill_chunk_size=256, load_score=True, head_score_dirs=dirs)
    jst = jeng.prefill(CTX_R, prefill_chunk_size=256, load_score=True, head_score_dirs=dirs)
    k_before, used = ev.cache.k, ev.cache.used_bytes()
    teng.prune(ev, 0.6, "head")
    reng.prune(rt, 0.6, "head")
    jeng.prune(jst, 0.6, "head")
    assert type(ev.cache).__name__ == "KVCache" and ev.cache.k is k_before
    ctx_rows = ev.cache.lengths - ev.sink
    assert set(ctx_rows.unique().tolist()) == {0, ev.ctx_len}
    assert ev.cache.used_bytes() < used
    np.testing.assert_array_equal(ev.cache.lengths.numpy(), np.asarray(jst.cache.lengths))
    q = teng.apply_template(QUERY)
    assert teng.generate(q, ev) == reng.generate(q, rt) == jeng.generate(q, jst)
