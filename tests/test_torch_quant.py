"""The port's quantization ops and W4A8 linears against the JAX package, on
the same inputs made with numpy from a seed, on the CPU.

Tolerances: the quantized bytes, int8 values and stored scales are held
bit for bit (both sides compute the scale in float32 and round it to the
storage dtype once). Linears and logits are held at atol = rtol = 1e-5 in
float32: both sides expand the same integers with the same scales and only
the summation order of the products differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.ops import quant as jquant
from kvzip_tpu.ops import w4a8 as jw4a8
from kvzip_tpu.ops import w4a8_v2 as jw4a8_v2
from kvzip_tpu_torch.ops import LAUNCHES, quant, w4a8, w4a8_v2

from test_torch_engine import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    """A numpy or JAX array as a torch tensor, bf16 kept bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _same(got: torch.Tensor, want) -> None:
    want = _t(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pack", ["pairs", "split"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_quantize_dequantize_bit_identical(pack, dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 256)) * 2.0).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(jax.device_get(jx))
    jq, js, jz = jquant.quantize_int4(jx, pack=pack)
    tq, ts, tz = quant.quantize_int4(tx, pack=pack)
    for got, want in ((tq, jq), (ts, js), (tz, jz)):
        _same(got, jax.device_get(want))
    want = jquant.dequantize_int4(jq, js, jz, jnp.float32, pack=pack)
    got = quant.dequantize_int4(tq, ts, tz, torch.float32, pack=pack)
    _same(got, jax.device_get(want))


def test_act_and_embed_int8_bit_identical():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((7, 384)).astype(np.float32)
    for got, want in zip(quant.quantize_act_int8(_t(x)),
                         jquant.quantize_act_int8(jnp.asarray(x))):
        _same(got, jax.device_get(want))
    w = (rng.standard_normal((64, 128)) * 0.02).astype(np.float32)
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        want = jquant.quantize_embed_int8(jnp.asarray(w), dtype)
        got = quant.quantize_embed_int8(_t(w), tdtype)
        for k in ("q", "s"):
            _same(got[k], jax.device_get(want[k]))


def test_int8_embed_lookup_and_head_logits_match():
    rng = np.random.default_rng(3)
    V, D = 96, 128
    table = (rng.standard_normal((V, D)) * 0.02).astype(np.float32)
    x = rng.standard_normal((5, D)).astype(np.float32)
    ids = np.asarray([0, 7, 95, 7], np.int32)
    jt = jquant.quantize_embed_int8(jnp.asarray(table), jnp.float32)
    tt = quant.quantize_embed_int8(_t(table), torch.float32)
    np.testing.assert_allclose(
        quant.embed_lookup(tt, torch.from_numpy(ids).long()).numpy(),
        np.asarray(jquant.embed_lookup(jt, jnp.asarray(ids))), **TOL)
    np.testing.assert_allclose(quant.head_logits(tt, _t(x)).numpy(),
                               np.asarray(jquant.head_logits(jt, jnp.asarray(x))),
                               **TOL)


def _layers(rng, L=2, D=256, I=384, att=256, kv=128):
    """Float projection stacks of a small decoder (numpy, float32)."""
    shapes = dict(wq=(D, att), wk=(D, kv), wv=(D, kv), wo=(att, D),
                  w_gate=(D, I), w_up=(D, I), w_down=(I, D))
    return {n: (rng.standard_normal((L, *s)) * 0.02).astype(np.float32)
            for n, s in shapes.items()}


IN_DIMS = dict(wqkv=256, wo=256, w_gateup=256, w_down=384)


def _v2_both(layers):
    """The same float stacks through quantize -> fuse -> repack on both
    sides: (JAX tree, port tree)."""
    jlp = {n: jw4a8.quantize_weight_int4(jnp.asarray(w)) for n, w in layers.items()}
    jlp = jw4a8_v2.repack_w4a8_layers(jw4a8.fuse_w4a8_params(jlp), IN_DIMS)
    tlp = {n: w4a8.quantize_weight_int4(_t(w)) for n, w in layers.items()}
    tlp = w4a8_v2.repack_w4a8_layers(w4a8.fuse_w4a8_params(tlp), IN_DIMS)
    return jax.device_get(jlp), tlp


def test_w4a8_v2_storage_bit_identical():
    rng = np.random.default_rng(4)
    w = _layers(rng)["w_down"]
    jw = jax.device_get(jw4a8.quantize_weight_int4(jnp.asarray(w)))
    tw = w4a8.quantize_weight_int4(_t(w))
    for k in ("q4", "s", "z"):
        _same(tw[k], jw[k])
    _same(w4a8.dequantize_weight_int4(tw, torch.float32),
          jax.device_get(jw4a8.dequantize_weight_int4(
              {k: jnp.asarray(v) for k, v in jw.items()}, jnp.float32)))
    jlp, tlp = _v2_both(_layers(rng))
    assert sorted(tlp) == sorted(jlp) == sorted(IN_DIMS)
    for name in jlp:
        for k in ("q4", "s2", "z2"):
            _same(tlp[name][k], jlp[name][k])


@pytest.mark.parametrize("T", [1, 5])
def test_w4a8_plain_matches_reference(T):
    """K8's plain version against ``w4a8_jnp_v2`` and the reference kernel
    in interpret mode, per fused weight and layer."""
    rng = np.random.default_rng(5 + T)
    jlp, tlp = _v2_both(_layers(rng))
    LAUNCHES["w4a8_matmul_stacked_v2"] = 0
    for name, w in jlp.items():
        x = rng.standard_normal((T, IN_DIMS[name])).astype(np.float32)
        for layer in range(2):
            got = w4a8_v2.w4a8_matmul_stacked_v2(
                _t(x), tlp[name]["q4"], tlp[name]["s2"], tlp[name]["z2"], layer)
            jl = {k: jnp.asarray(v[layer]) for k, v in w.items()}
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jw4a8_v2.w4a8_jnp_v2(jnp.asarray(x), jl)),
                **TOL)
            kern = jw4a8_v2.w4a8_matmul_stacked_v2(
                jnp.asarray(x), *(jnp.asarray(w[k]) for k in ("q4", "s2", "z2")),
                jnp.asarray(layer, jnp.int32), interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    assert LAUNCHES["w4a8_matmul_stacked_v2"] == 0  # CPU: the plain version


def test_w4a8_dequant_route_matches_reference():
    """The T >= 512 route (dequantize the layer to bf16, one product)."""
    rng = np.random.default_rng(6)
    jlp, tlp = _v2_both(_layers(rng))
    x = rng.standard_normal((w4a8.DEQUANT_T, 256)).astype(np.float32)
    for name in ("wqkv", "w_gateup"):
        got = w4a8._w4a8_dequant_matmul(_t(x), tlp[name], 1)
        want = jw4a8._w4a8_dequant_matmul(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in jlp[name].items()},
            jnp.asarray(1, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
