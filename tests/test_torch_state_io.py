"""``Engine.save_state``/``load_state`` (``kvzip_tpu_torch/state_file.py``)
and the converter of a ``kvzip_tpu`` state file, float32 on the CPU, one
reference engine for the module (``flat_decode="on"``: the reference
builds its pool on the CPU only so).

Tolerances: a converted reference pool loads with each layer's live rows,
scales, zeros and ``row_head`` equal to the reference's (K and packed
rows transposed back, laid out on 64-row segments), its tail grown to
the port engine's larger ``decode_budget``, and answers with the
reference's tokens, float32 and int4 KV. A port state saved after an
``update_cache`` turn (a non-empty tail) and loaded by a fresh engine
holds the same arrays and counters and gives the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu_torch import state_file
from kvzip_tpu_torch.pool import POOL_ALIGN, PoolInt4KV, PoolKV

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_retain import CTX_R, KW, QUERY, SHAPE, IdTokenizer, _tree, port_engine


@pytest.fixture(scope="module")
def engines():
    tree = _tree(SHAPE)
    jeng = JEngine("tiny-llama", config=tiny_config("llama", **SHAPE),
                   params=jax.tree_util.tree_map(jnp.asarray, tree),
                   tokenizer=IdTokenizer(512), dtype=jnp.float32, flat_decode="on", **KW)
    return jeng, tree


def _live(pool, heads):
    """{(layer, head): its live rows of every row field, in order}."""
    names = ("k_pool_q", "v_pool_q", "k_pool_s", "k_pool_z", "v_pool_s", "v_pool_z") \
        if isinstance(pool, PoolInt4KV) else ("k_pool", "v_pool")
    out = {}
    for l in range(pool.layer_off.shape[0]):
        o, n = int(pool.layer_off[l]), int(pool.layer_rows[l])
        rh = pool.row_head[o:o + n]
        for h in heads:
            out[l, h] = [getattr(pool, f)[o:o + n][rh == h] for f in names]
    return out


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_converted_reference_state_gives_reference_tokens(engines, tmp_path, kv_quant):
    jeng, tree = engines
    jeng.kv_quant = kv_quant
    try:
        jst = jeng.prefill(CTX_R, prefill_chunk_size=256)
        jeng.prune(jst, 0.3, "pair")
        src = jeng.save_state(jst, str(tmp_path / "ref"))
        dst = state_file.convert_reference_state(src, str(tmp_path / "port"))
        teng = port_engine(tree, kv_quant=kv_quant, decode_budget=KW["decode_budget"] + 64)
        tst = teng.load_state(dst)
        pool = tst.cache
        assert isinstance(pool, PoolInt4KV if kv_quant == "int4" else PoolKV)
        assert pool.align == POOL_ALIGN and (pool.layer_off % POOL_ALIGN == 0).all()
        assert pool.k_tail.shape[2] == teng.decode_budget
        np.testing.assert_array_equal(pool.lengths.numpy(), np.asarray(jst.cache.lengths))
        np.testing.assert_array_equal(pool.layer_rows.numpy(), np.asarray(jst.cache.layer_rows))
        ref = jst.cache
        for l in range(pool.layer_off.shape[0]):
            o, jo, n = int(pool.layer_off[l]), int(ref.layer_off[l]), int(ref.layer_rows[l])
            assert torch.equal(pool.row_head[o:o + n],
                               torch.from_numpy(np.array(ref.row_head)[0, jo:jo + n]))
            names = (("k_pool_q", True), ("v_pool_q", True), ("k_pool_s", False))
            if kv_quant == "none":
                names = (("k_pool", True), ("v_pool", False))
            for f, t in names:
                a = np.array(getattr(ref, f))
                a = a.T[jo:jo + n] if t else (a[0, jo:jo + n] if a.shape[0] == 1
                                              else a[jo:jo + n])
                assert torch.equal(getattr(pool, f)[o:o + n], torch.from_numpy(a)), (l, f)
        assert (pool.row_head[int(pool.layer_rows[0]):int(pool.layer_off[1])] == -1).all()
        assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)
        assert int(pool.tail_len) == 0 and int(pool.seen) == tst.prefill_len
    finally:
        jeng.kv_quant = "none"


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_save_load_round_trip_after_an_update_turn(engines, tmp_path, kv_quant):
    _, tree = engines
    teng = port_engine(tree, kv_quant=kv_quant, flat_decode="on")
    st = teng.prefill(CTX_R, prefill_chunk_size=256)
    teng.prune(st, 0.3, "pair")
    teng.generate("First turn.", st, update_cache=True)
    assert int(st.cache.tail_len) > 0
    path = teng.save_state(st, str(tmp_path / "state.npz"))
    fresh = port_engine(tree, kv_quant=kv_quant, flat_decode="on")
    got = fresh.load_state(path)
    for f in ("row_head", "layer_off", "layer_rows", "k_tail", "v_tail", "lengths",
              "tail_lens", "seen"):
        assert torch.equal(getattr(got.cache, f), getattr(st.cache, f)), f
    assert int(got.cache.tail_len) == int(st.cache.tail_len)
    assert (got.sink, got.ctx_len, got.prefill_len) == (st.sink, st.ctx_len, st.prefill_len)
    assert fresh.generate(QUERY, got) == teng.generate(QUERY, st)
    dense = teng.prefill(CTX_R[:200], prefill_chunk_size=256, do_score=False)
    with pytest.raises(ValueError, match="pool"):
        teng.save_state(dense, str(tmp_path / "dense"))
    other = port_engine(tree, kv_quant=kv_quant)
    other.name = "tiny-qwen2"
    with pytest.raises(ValueError, match="saved for"):
        other.load_state(path)
