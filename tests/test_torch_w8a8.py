"""The port's W8A8 pieces against the reference, on the CPU, from the same
seeded numpy inputs:

- ``quantize_weight_int8``: int8 bytes (the port stores them transposed,
  ``(out, in)``) and float32 scales identical;
- ``int8_matmul`` / ``int8_linear``: the int32 product is exact, so with a
  float32 output (scales and bias applied in the same order) the results
  are identical;
- ``quantize_params_w8a8`` and ``params_from_jax``: the same bytes whichever
  package quantized;
- the plain versions of K13 (``rmsnorm_quant``) and K14
  (``silu_mul_quant``) against the reference's Pallas kernels in interpret
  mode, gemma on and off, both activations. The two frameworks sum the
  squares and evaluate rsqrt, exp and tanh with other last bits, which can
  move a value lying on a rounding boundary one int8 step; so the int8
  rows are held equal except for one step on at most 1e-3 of the elements,
  the scales to 1e-5 relative (``ops.quant_parity``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.config import tiny_config
from kvzip_tpu.models import params as jparams
from kvzip_tpu.ops import fused_act as jfused
from kvzip_tpu.ops import quant as jquant
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch.models.params import init_params_w8a8, params_from_jax, prepare_params
from kvzip_tpu_torch.ops import fused_act, quant, quant_parity

from test_torch_engine import one_torch_thread  # noqa: F401


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(96, 40), (2, 256, 72)])
def test_quantize_weight_int8_bytes_and_scales_identical(shape):
    w = (_rng().standard_normal(shape) * 0.02).astype(np.float32)
    w[..., 3, :] *= 40.0  # an outlier row sets some channels' scales
    want = jquant.quantize_weight_int8(jnp.asarray(w))
    got = quant.quantize_weight_int8(_t(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].transpose(-1, -2).numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.mark.parametrize("bias", [False, True])
def test_int8_matmul_and_linear_exact(bias):
    r = _rng(1)
    T, IN, OUT = 7, 264, 96
    x = (r.standard_normal((T, IN)) * 3).astype(np.float32)
    w = (r.standard_normal((IN, OUT)) * 0.05).astype(np.float32)
    b = (r.standard_normal(OUT) * 0.1).astype(np.float32) if bias else None
    jw = jquant.quantize_weight_int8(jnp.asarray(w))
    tw = quant.quantize_weight_int8(_t(w))
    jxq, jxs = jquant.quantize_act_int8(jnp.asarray(x))
    txq, txs = quant.quantize_act_int8(_t(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    acc = jax.lax.dot_general(jxq, jw["q"], (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(quant._int8_rows_dot(txq, tw["q"]).numpy(), np.asarray(acc))
    jb, tb = (None, None) if b is None else (jnp.asarray(b), _t(b))
    want = jquant.int8_matmul(jxq, jxs, jw["q"], jw["s"], jb, jnp.float32)
    got = quant.int8_matmul(txq, txs, tw["q"], tw["s"], tb, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jquant.int8_linear(jnp.asarray(x), jw["q"], jw["s"], jb)
    got = quant.int8_linear(_t(x), tw["q"], tw["s"], tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_w8a8_params_carry_across_and_quantize_alike():
    """The reference's W8A8 tree carried by ``params_from_jax`` equals the
    port quantizing the same float tree itself; random init gives the
    same structure and dtypes."""
    jcfg = tiny_config("qwen2", num_layers=2)
    tcfg = tconfig.tiny_config("qwen2", num_layers=2)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    carried = params_from_jax(jax.device_get(jquant.quantize_params_w8a8(
        jax.tree_util.tree_map(jnp.asarray, tree))), "cpu", torch.float32)
    own = prepare_params(tcfg, params_from_jax(tree, "cpu", torch.float32),
                         dtype=torch.float32, weight_quant="w8a8", device="cpu")
    init = init_params_w8a8(tcfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        L, IN, OUT = tree["layers"][name].shape
        for p in (carried, own, init):
            w = p["layers"][name]
            assert w["q"].shape == (L, OUT, IN) and w["q"].dtype == torch.int8
            assert w["s"].shape == (L, OUT) and w["s"].dtype == torch.float32
            assert w["q"].is_contiguous()
        for k in ("q", "s"):
            assert torch.equal(own["layers"][name][k], carried["layers"][name][k]), (name, k)
    assert torch.equal(carried["layers"]["bq"], own["layers"]["bq"])
    assert carried["embed"].dtype == torch.float32


def _act_inputs(seed, T, W):
    r = _rng(seed)
    x = (r.standard_normal((T, W)) * 2).astype(np.float32)
    x[:, 5] *= 30.0  # an outlier channel, as real activations have
    return x


@pytest.mark.parametrize("gemma", [False, True])
@pytest.mark.parametrize("T,D", [(5, 256), (37, 384)])
def test_rmsnorm_quant_plain_matches_reference_kernel(gemma, T, D):
    x = _act_inputs(2, T, D)
    w = (1.0 + 0.3 * _rng(3).standard_normal(D)).astype(np.float32)
    jq, js = jfused.rmsnorm_quant(jnp.asarray(x), jnp.asarray(w), 1e-5, gemma=gemma,
                                  interpret=True)
    tq, ts = fused_act.rmsnorm_quant(_t(x), _t(w), 1e-5, gemma=gemma)
    assert tq.dtype == torch.int8 and ts.shape == (T, 1) and ts.dtype == torch.float32
    r = quant_parity(tq, ts, _t(jq), _t(js))
    assert r["ok"], r


@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh"])
@pytest.mark.parametrize("T,F", [(5, 256), (37, 640)])
def test_silu_mul_quant_plain_matches_reference_kernel(act, T, F):
    gate, up = _act_inputs(4, T, F), _act_inputs(5, T, F)
    jq, js = jfused.silu_mul_quant(jnp.asarray(gate), jnp.asarray(up), act=act,
                                   interpret=True)
    tq, ts = fused_act.silu_mul_quant(_t(gate), _t(up), act=act)
    r = quant_parity(tq, ts, _t(jq), _t(js))
    assert r["ok"], r


def test_quant_parity_rejects_a_doubled_scale_and_a_shifted_row():
    """The gate that holds K13/K14 on the card fails a reference whose one
    row's scale is doubled, or whose one row is two steps off."""
    x = _t(_act_inputs(6, 9, 256))
    q, s = fused_act.rmsnorm_quant(x, torch.ones(256), 1e-5)
    assert quant_parity(q, s, q, s)["ok"]
    s2 = s.clone()
    s2[3] *= 2
    assert not quant_parity(q, s, q, s2)["ok"]
    q2 = q.clone()
    q2[4, :2] = (q2[4, :2].int() + 2).clamp(-127, 127).to(torch.int8)
    assert not quant_parity(q, s, q2, s)["ok"]


def test_fused_act_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="act"):
        fused_act.silu_mul_quant(torch.zeros(2, 8), torch.zeros(2, 8), act="relu")
