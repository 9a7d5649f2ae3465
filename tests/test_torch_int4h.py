"""The port's int4 lm_head (``embed_quant="int4h"``) against the JAX
package, on the CPU: ``quantize_head_int4``, the int4 branch of
``head_logits``, the tied-head refusal, and an int4h engine beside the
reference's on the same tree.

Tolerances: the head's bytes and scales bit for bit; logits at atol =
rtol = 1e-5 in float32 (the same integers and scales, another summation
order). The int4 head against the plain float head is held to the
reference's own bound (``tests/test_quant.py``): max error below 0.2 of
the largest |logit|, and the argmax kept wherever the top-2 margin exceeds
0.3 of it. The engines from the same tokens: scores at atol = rtol = 1e-5
(float32 KV and weights, as ``test_torch_engine.py``) and the same greedy
tokens on the dense cache and on the pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.ops import quant as jquant
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.models.params import params_from_jax, prepare_params
from kvzip_tpu_torch.ops import quant

from test_torch_engine import IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_engine_quant import CTX_Q, QUERY_Q
from test_torch_quant import _t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_head_int4_bit_identical(dtype):
    rng = np.random.default_rng(0)
    head = (rng.standard_normal((512, 256)) * 0.05).astype(np.float32)
    want = jax.device_get(jquant.quantize_head_int4(jnp.asarray(head), getattr(jnp, dtype)))
    got = quant.quantize_head_int4(_t(head), getattr(torch, dtype))
    assert sorted(got) == sorted(want) == ["q4", "s2", "z2"]
    assert got["q4"].shape == (1, 256, 256)
    for k in want:
        assert torch.equal(got[k], _t(want[k])), k


def test_int4_head_logits_match_reference_and_its_bound():
    rng = np.random.default_rng(1)
    V, D = 512, 256
    head = (rng.standard_normal((V, D)) * 0.05).astype(np.float32)
    x = rng.standard_normal((3, D)).astype(np.float32)
    th = quant.quantize_head_int4(_t(head), torch.float32)
    got = quant.head_logits(th, _t(x)).numpy()
    jh = jquant.quantize_head_int4(jnp.asarray(head), jnp.float32)
    np.testing.assert_allclose(got, np.asarray(jquant.head_logits(jh, jnp.asarray(x))), **TOL)
    ref = quant.head_logits(_t(head), _t(x)).numpy()
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < 0.2, err
    srt = np.sort(ref, axis=1)
    clear = (srt[:, -1] - srt[:, -2]) > 0.3 * np.abs(ref).max()
    assert (ref.argmax(1)[clear] == got.argmax(1)[clear]).all()


def test_int4h_refuses_a_tied_head():
    cfg = tconfig.tiny_config("llama", tie_word_embeddings=True, num_layers=1)
    with pytest.raises(ValueError, match="untied lm_head"):
        prepare_params(cfg, dtype=torch.float32, embed_quant="int4h",
                       generator=torch.Generator().manual_seed(0), device="cpu")


def test_int4h_engine_matches_reference():
    shape = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2)
    jcfg = tiny_config("llama", **shape)
    tcfg = tconfig.tiny_config("llama", **shape)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    # weights at 7x the init scale, as in test_torch_engine.py
    for name in jparams._BIG_SLOTS:
        tree["layers"][name] = tree["layers"][name] * np.float32(7.0)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), max_new_tokens=8, decode_budget=136,
              capacity_granularity=256, score_chunk_size=256, embed_quant="int4h")
    jeng = JEngine("tiny-llama", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    teng = Engine("tiny-llama", config=tcfg, params=params_from_jax(tree, "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    jp = jax.device_get(jeng.params)
    for k in ("q4", "s2", "z2"):
        assert torch.equal(teng.params["lm_head"][k], _t(jp["lm_head"][k])), k
    for k in ("q", "s"):
        assert torch.equal(teng.params["embed"][k], _t(jp["embed"][k])), k

    jst = jeng.prefill(CTX_Q, prefill_chunk_size=256)
    tst = teng.prefill(CTX_Q, prefill_chunk_size=256)
    np.testing.assert_allclose(tst.score.numpy(), np.asarray(jst.score), **TOL)
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)
