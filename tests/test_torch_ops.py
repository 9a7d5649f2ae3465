"""The port's plain K1-K4 versions against the reference's Pallas kernels
run in interpret mode, on the same float32 inputs made with numpy.

Tolerance: atol = rtol = 1e-5 on attention outputs and scores (both sides
compute in float32; only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kvzip_tpu.ops import flash as jflash
from kvzip_tpu.ops import pool_decode as jpool
from kvzip_tpu.ops import ragged_decode as jragged
from kvzip_tpu.ops import score_kernel as jscore
from kvzip_tpu_torch.ops import flash, pool_decode, ragged_decode, score_kernel

from test_torch_engine import one_torch_thread  # noqa: F401

D = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (20, [108, 0]): base + T = C on head 0, base 0 on head 1, and T no
# multiple of the reference's 8-query block or the kernel's 128
@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("T,lens", [(16, [40, 3]), (32, [0, 77]), (20, [108, 0])])
def test_flash_plain_matches_reference_kernel(G, T, lens):
    rng = np.random.default_rng(G * 100 + T)
    Hkv, C = 2, 128
    q = rng.standard_normal((T, Hkv * G, D), np.float32)
    k = rng.standard_normal((Hkv, C, D), np.float32)
    v = rng.standard_normal((Hkv, C, D), np.float32)
    base = np.asarray(lens, np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jflash.flash_attend(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(base),
            jnp.asarray(0, jnp.int32), scale=D ** -0.5, block_q=8, block_k=32)
    got = flash.flash_attend(_t(q), _t(k), _t(v), _t(base), scale=D ** -0.5)
    _close(got, want)


# "edges": base + T = C on head 0 and base 0 on head 2
@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("lens_kind", ["ragged", "edges"])
def test_ragged_decode_plain_matches_reference_kernel(G, T, lens_kind):
    rng = np.random.default_rng(G * 10 + T)
    Hkv, C = 3, 128
    q = rng.standard_normal((T, Hkv * G, D), np.float32)
    k = rng.standard_normal((Hkv, C, D), np.float32)
    v = rng.standard_normal((Hkv, C, D), np.float32)
    base = np.asarray([25, 0, 97] if lens_kind == "ragged" else [C - T, 61, 0],
                      np.int32)
    want = jragged.ragged_decode_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(base),
        scale=D ** -0.5, block_kv=32, interpret=True)
    got = ragged_decode.ragged_decode_attend(_t(q), _t(k), _t(v), _t(base),
                                             scale=D ** -0.5)
    _close(got, want)


# K4's grid at the main paths' shapes (qwen2.5-7b and llama3.1-8b at a
# 16k context, T 1 and 8) and at the cuda lane's
@pytest.mark.parametrize("C,Hkv,G,T,live", [
    (19456, 4, 7, 1, 16545), (19456, 4, 7, 8, 16552), (19456, 8, 4, 1, 16610),
    (19456, 8, 4, 8, 16617), (4000, 2, 2, 3, 1), (4000, 4, 7, 8, 4000),
    (128, 3, 7, 8, 33)])
def test_ragged_decode_split_plan_covers_each_live_row_once(C, Hkv, G, T, live):
    sms = 132
    S, groups = ragged_decode.plan_splits(C, Hkv, G * T, sms)
    assert groups == -(-G * T // ragged_decode.ROWS_PER_CTA)
    assert 1 <= Hkv * groups * S <= sms  # at most one CTA a SM
    bounds = ragged_decode.split_bounds(live, S)
    assert len(bounds) == S
    covered = np.zeros(live, np.int32)
    for k0, k1 in bounds:
        assert 0 <= k0 <= k1 <= live
        assert k0 % ragged_decode.SPLIT_ALIGN == 0 or k0 == live
        covered[k0:k1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("ctx_len,q_valid,model_dtype", [
    (24, 32, "float32"),      # full window, no padded query
    (17, 27, "float32"),      # short last window, padded queries
    (17, 27, "bfloat16"),     # logits rounded to bf16 before the softmax
])
def test_scores_plain_match_reference_kernel(G, ctx_len, q_valid, model_dtype):
    rng = np.random.default_rng(G + ctx_len)
    Hkv, sink, s_ctx, T = 2, 5, 24, 32
    q = rng.standard_normal((T, Hkv * G, D), np.float32)
    keys = rng.standard_normal((Hkv, sink + s_ctx + T, D), np.float32)
    want = jscore.fused_scores(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(ctx_len, jnp.int32),
        jnp.asarray(q_valid, jnp.int32), sink=sink, s_ctx=s_ctx,
        scale=D ** -0.5, block_q=8, interpret=True,
        model_dtype=getattr(jnp, model_dtype))
    got = score_kernel.fused_scores(
        _t(q), _t(keys), ctx_len, q_valid, sink=sink, s_ctx=s_ctx,
        scale=D ** -0.5, model_dtype=getattr(torch, model_dtype))
    _close(got, want)
    assert not got[:, ctx_len:].any()


@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("T,layer", [(1, 0), (4, 1), (1, 2)])
def test_pool_decode_plain_matches_reference_kernel(G, T, layer):
    rng = np.random.default_rng(G * 7 + T + layer)
    L, Hkv, Tcap, tail_len, align = 3, 2, 8, 3, 32
    rows = [40, 64, 17]
    r_pad = [max(align, -(-r // align) * align) for r in rows]
    off = np.concatenate([[0], np.cumsum(r_pad)[:-1]]).astype(np.int32)
    alloc, max_rows = int(off[-1] + max(r_pad)), max(r_pad)
    k_pool = rng.standard_normal((alloc, D), np.float32)
    v_pool = rng.standard_normal((alloc, D), np.float32)
    rh = np.full((alloc,), -1, np.int32)
    for o, r in zip(off, rows):
        rh[o:o + r] = np.sort(rng.integers(0, Hkv, size=r))
    rh[off[1] + 5] = -1          # a padding row inside a live range
    k_tail = rng.standard_normal((L, Hkv, Tcap, D), np.float32)
    v_tail = rng.standard_normal((L, Hkv, Tcap, D), np.float32)
    q = rng.standard_normal((T, Hkv * G, D), np.float32)
    want = jpool.pool_decode_attend(
        jnp.asarray(q), jnp.asarray(k_pool.T), jnp.asarray(v_pool),
        jnp.asarray(rh)[None], jnp.asarray(off), jnp.asarray(rows, jnp.int32),
        jnp.asarray(k_tail), jnp.asarray(v_tail),
        jnp.asarray(tail_len, jnp.int32), jnp.asarray(layer, jnp.int32),
        scale=D ** -0.5, align=align, max_rows=max_rows, block=32,
        interpret=True)
    got = pool_decode.pool_decode_attend(
        _t(q), _t(k_pool), _t(v_pool), _t(rh), _t(off),
        _t(np.asarray(rows, np.int32)), _t(k_tail), _t(v_tail), tail_len,
        layer, scale=D ** -0.5, max_rows=max_rows)
    _close(got, want)
