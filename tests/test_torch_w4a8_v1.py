"""The port's v1 W4A8 storage path against the JAX package, on the CPU: the
plain K15 (``w4a8_matmul_stacked``) and K16 (``w4a8_matmul``) against the
reference kernels in interpret mode, ``_w4a8_jnp``, the v1 dequant route,
``_lin`` and ``w4a8_linear_stacked`` on v1 dicts, ``fuse_w4a8_params`` on
v1 stacks, and ``Engine(params=<v1 tree>, weight_quant="none")`` of both
packages on the same tree, unfused and fused.

Tolerances: bytes and scales bit for bit. The port's plain versions
against the reference's ``_w4a8_jnp`` and dequant route at atol = rtol =
1e-5 in float32 (the same integers and scales, another summation order);
against the reference kernels in interpret mode at 2e-4, the reference's
own hold of its kernel against ``_w4a8_jnp`` (``tests/test_w4a8.py``: the
kernel folds the scales per group after an integer dot). The engines as
``tests/test_torch_engine_quant.py`` holds them: from the same tokens the
dense int4 nibbles one step apart at most, scores correlated >= 0.98 and
pair keep masks at ratio 0.3 agreeing on >= 95% of the entries; from one
carried state the same pool and the same greedy tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import prune as jprune
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.models import transformer as jtransformer
from kvzip_tpu.ops import w4a8 as jw4a8
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch import prune
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.models import transformer
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.ops import LAUNCHES, reset_launches, w4a8
from kvzip_tpu_torch.pool import PoolInt4KV

from test_torch_engine import IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_engine_quant import CTX_Q, QUERY_Q, _carry_dense, _np, _same_pools
from test_torch_quant import _t

TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _v1(rng, L, IN, OUT):
    """One float stack quantized to v1 by the reference: (numpy dict, port
    dict)."""
    w = (rng.standard_normal((L, IN, OUT)) * 0.02).astype(np.float32)
    jw = jax.device_get(jw4a8.quantize_weight_int4(jnp.asarray(w)))
    return jw, {k: _t(v) for k, v in jw.items()}


def test_v1_storage_bit_identical_and_pads():
    """IN 2304 is 18 groups, stored as 32 (pad groups of s = z = 0)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 2304, 256)) * 0.02).astype(np.float32)
    jw = jax.device_get(jw4a8.quantize_weight_int4(jnp.asarray(w)))
    tw = w4a8.quantize_weight_int4(_t(w))
    assert tw["q4"].shape == (2, 4096, 128) and tw["s"].shape == (2, 32, 256)
    for k in ("q4", "s", "z"):
        assert torch.equal(tw[k], _t(jw[k])), k
    assert not tw["s"][:, 18:].any() and not tw["z"][:, 18:].any()


@pytest.mark.parametrize("chunk_layers", [None, 3])
def test_quantize_layer_stacks_any_chunk_bit_identical(chunk_layers):
    """One layer at a time (the default) or three, a five-layer stack
    quantizes to the reference's bytes and scales (its chunks of four)."""
    from kvzip_tpu_torch.models.params import quantize_layer_stacks

    rng = np.random.default_rng(5)
    lp = {"wq": (rng.standard_normal((5, 256, 128)) * 0.02).astype(np.float32),
          "ln_attn": np.ones((5, 256), np.float32)}
    jq = jax.device_get(jparams.quantize_layer_stacks(
        {k: jnp.asarray(v) for k, v in lp.items()}, jw4a8.quantize_weight_int4))
    kw = {} if chunk_layers is None else dict(chunk_layers=chunk_layers)
    tq = quantize_layer_stacks({k: _t(v) for k, v in lp.items()}, w4a8.quantize_weight_int4,
                               **kw)
    assert torch.equal(tq["ln_attn"], _t(lp["ln_attn"]))
    for k in ("q4", "s", "z"):
        assert torch.equal(tq["wq"][k], _t(jq["wq"][k])), k


@pytest.mark.parametrize("T", [1, 9])
def test_plain_k15_matches_reference_kernel_at_every_layer(T):
    rng = np.random.default_rng(1 + T)
    L, IN, OUT = 3, 2304, 256
    jw, tw = _v1(rng, L, IN, OUT)
    x = rng.standard_normal((T, IN)).astype(np.float32)
    reset_launches()
    for layer in range(L):
        got = w4a8.w4a8_matmul_stacked(_t(x), tw["q4"], tw["s"], tw["z"], layer)
        kern = jw4a8.w4a8_matmul_stacked(
            jnp.asarray(x), *(jnp.asarray(jw[k]) for k in ("q4", "s", "z")),
            jnp.asarray(layer, jnp.int32), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), **KERNEL_TOL)
        want = jw4a8._w4a8_jnp(jnp.asarray(x), {k: jnp.asarray(v[layer])
                                                for k, v in jw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(LAUNCHES.values()) == 0  # CPU: the plain version


@pytest.mark.parametrize("IN,T,with_bias", [(2304, 9, True), (256, 1, False)])
def test_plain_k16_matches_reference_kernel(IN, T, with_bias):
    rng = np.random.default_rng(3)
    jw, tw = _v1(rng, 1, IN, 384)
    jw, tw = {k: v[0] for k, v in jw.items()}, {k: v[0] for k, v in tw.items()}
    x = rng.standard_normal((T, IN)).astype(np.float32)
    b = rng.standard_normal(384).astype(np.float32) if with_bias else None
    got = w4a8.w4a8_matmul(_t(x), tw["q4"], tw["s"], tw["z"],
                           None if b is None else _t(b))
    kern = jw4a8.w4a8_matmul(jnp.asarray(x), *(jnp.asarray(jw[k]) for k in ("q4", "s", "z")),
                             None if b is None else jnp.asarray(b), block_t=8,
                             interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **KERNEL_TOL)
    lin = w4a8.w4a8_linear(_t(x), tw, None if b is None else _t(b))
    assert torch.equal(lin, got)


def test_w4a8_jnp_and_bf16_bias_match_reference():
    """``_w4a8_jnp`` on a padded weight; in bf16 the bias is added to the
    bf16 output (one more bf16 rounding), as the reference adds it."""
    rng = np.random.default_rng(4)
    jw, tw = _v1(rng, 1, 2304, 256)
    jw, tw = {k: v[0] for k, v in jw.items()}, {k: v[0] for k, v in tw.items()}
    jl = {k: jnp.asarray(v) for k, v in jw.items()}
    x = rng.standard_normal((5, 2304)).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(w4a8._w4a8_jnp(_t(x), tw, _t(b)).numpy(),
                               np.asarray(jw4a8._w4a8_jnp(jnp.asarray(x), jl, jnp.asarray(b))),
                               **TOL)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jw4a8._w4a8_jnp(xb, jl, jnp.asarray(b).astype(jnp.bfloat16))
    got = w4a8._w4a8_jnp(_t(jax.device_get(xb)), tw, _t(b).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # bf16 outputs: one bf16 step (2^-8 relative) of rounding-order slack
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_v1_dequant_route_and_stacked_dispatch_match_reference():
    """The T >= 512 route (dequantize the layer to bf16, zero pad rows, one
    product) and ``w4a8_linear_stacked`` on a v1 stack with a bias (the
    CPU dispatch: the plain K15 of the layer slice)."""
    rng = np.random.default_rng(5)
    jw, tw = _v1(rng, 2, 2304, 256)
    js = {k: jnp.asarray(v) for k, v in jw.items()}
    x = rng.standard_normal((w4a8.DEQUANT_T, 2304)).astype(np.float32)
    got = w4a8._w4a8_dequant_matmul(_t(x), tw, 1)
    want = jw4a8._w4a8_dequant_matmul(jnp.asarray(x), js, jnp.asarray(1, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    b = rng.standard_normal(256).astype(np.float32)
    got = w4a8.w4a8_linear_stacked(_t(x[:7]), tw, 1, _t(b))
    want = jw4a8.w4a8_linear_stacked(jnp.asarray(x[:7]), js, jnp.asarray(1, jnp.int32),
                                     jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lin_takes_a_v1_dict():
    rng = np.random.default_rng(6)
    jw, tw = _v1(rng, 1, 256, 128)
    jw, tw = {k: v[0] for k, v in jw.items()}, {k: v[0] for k, v in tw.items()}
    x = rng.standard_normal((3, 256)).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    got = transformer._lin(_t(x), tw, _t(b))
    want = jtransformer._lin(jnp.asarray(x), {k: jnp.asarray(v) for k, v in jw.items()},
                             jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fuse_w4a8_params_on_v1_bit_identical():
    """The port's fusion of the reference's unfused v1 stacks against the
    reference's fusion of the same stacks (the engines' trees below)."""
    tlp = w4a8.fuse_w4a8_params(params_from_jax(_v1_tree(False), "cpu")["layers"])
    jlp = _v1_tree(True)["layers"]
    assert sorted(tlp) == sorted(jlp)
    for name in ("wqkv", "w_gateup"):
        for k in ("q4", "s", "z"):
            assert torch.equal(tlp[name][k], _t(jlp[name][k])), (name, k)


# ------------------------------------------------------------ the engines
V1 = dict(kv_quant="int4", weight_quant="none", embed_quant="int8")


@functools.lru_cache(maxsize=None)
def _v1_tree(fused: bool) -> dict:
    """The reference's float tree (weights at 7x the init scale, as in
    ``test_torch_engine.py``) quantized to v1 by the reference, and for
    ``fused`` its qkv and gate/up stacks fused by the reference;
    intermediate 2304 gives ``w_down`` pad groups. Read-only (cached)."""
    if fused:
        tree = _v1_tree(False)
        return {**tree, "layers": jax.device_get(jw4a8.fuse_w4a8_params(
            jax.tree_util.tree_map(jnp.asarray, tree["layers"])))}
    jcfg = tiny_config("qwen2", **SHAPE)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    lp = {n: (w * np.float32(7.0) if n in jparams._BIG_SLOTS else w)
          for n, w in tree["layers"].items()}
    lp = jparams.quantize_layer_stacks(lp, jw4a8.quantize_weight_int4)
    return jax.device_get({**tree, "layers": lp})


SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2,
             intermediate_size=2304)


@pytest.fixture(scope="module", params=["unfused", "fused"])
def engines(request):
    tree = _v1_tree(request.param == "fused")
    jcfg = tiny_config("qwen2", **SHAPE)
    tcfg = tconfig.tiny_config("qwen2", **SHAPE)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), max_new_tokens=4,
              decode_budget=132, capacity_granularity=256, score_chunk_size=256, **V1)
    jeng = JEngine("tiny-qwen2", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    teng = Engine("tiny-qwen2", config=tcfg, params=params_from_jax(tree, "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    return request.param, jeng, teng


def test_v1_engine_matches_reference(engines):
    """Both engines keep the v1 stacks as they are; from the same tokens
    the int4 cache and the scores agree within rounding noise; from the
    reference's scored state the same answers, the same pool and the same
    answers on it."""
    kind, jeng, teng = engines
    names = ("wqkv", "wo", "w_gateup", "w_down") if kind == "fused" else jparams._BIG_SLOTS
    jp = jax.device_get(jeng.params)
    for n in names:
        for k in ("q4", "s", "z"):
            assert torch.equal(teng.params["layers"][n][k], _t(jp["layers"][n][k])), (n, k)
    assert "s2" not in teng.params["layers"][names[0]]

    jst = jeng.prefill(CTX_Q, prefill_chunk_size=256)
    tst = teng.prefill(CTX_Q, prefill_chunk_size=256)
    np.testing.assert_array_equal(tst.cache.lengths.numpy(), np.asarray(jst.cache.lengths))
    want = _carry_dense(jst.cache)
    n = int(tst.cache.lengths.max())
    for f in ("k_q", "v_q"):
        got, ref = (getattr(c, f)[:, :, :n].int() for c in (tst.cache, want))
        for shift in (4, 0):
            assert ((got >> shift & 15) - (ref >> shift & 15)).abs().max() <= 1
    j_score, t_score = np.asarray(jst.score), tst.score.numpy()
    corr = np.corrcoef(t_score.ravel(), j_score.ravel())[0, 1]
    keep = prune.prune_mask(tst.score, 0.3, "pair", method="histogram")[0].numpy()
    j_keep = np.asarray(jprune.prune_mask(jnp.asarray(j_score), 0.3, "pair",
                                          method="histogram")[0])
    assert corr >= 0.98 and (keep == j_keep).mean() >= 0.95, (corr, (keep == j_keep).mean())

    tst = dataclasses.replace(tst, cache=_carry_dense(jst.cache), score=_np(jst.score))
    tst.snapshot()
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    assert isinstance(tst.cache, PoolInt4KV)
    _same_pools(tst.cache, jst.cache)
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
