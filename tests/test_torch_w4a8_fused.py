"""The fused W4A8 decode layer (K12, ``w4a8_layer_fused``) and the
``fuse_layer`` path of the port's forward, against the JAX package on the
CPU.

(a) The plain K12 against ``kvzip_tpu.ops.w4a8_fused.w4a8_layer_fused`` in
interpret mode, at ``tests/test_w4a8_fused.py``'s sizes, on inputs made
with numpy from a seed and the reference's own v2 weights carried across.
Both sides round at the same points and sum each group's integer products
exactly, so they differ only in float32 summation order: held to 1e-6 of
the largest reference value in float32 (measured: 3e-7) and to one bf16
step of it (2^-8) in bf16 (measured: identical). The reference's own test
holds the kernel to the composed path at 3e-2.

(b) End to end from one carried state (the reference's dense int4 cache and
scores, as ``test_torch_engine_quant.py`` carries them), on the pool and
the legacy flat layout, with ``fuse_layer="on"``: the port's greedy tokens
equal its own composed ("off") ones, as ``tests/test_w4a8_fused.py``
holds the reference, and the reference engine's composed ones; with the
reference forward's choice of qkv weights (see the test) they equal the
reference engine's fused ones.

(c) The fused layer runs only where the gate lets it: with "off", on W8A8
or plain weights, and in prefill or scoring it is never called.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.ops.w4a8 import quantize_weight_int4
from kvzip_tpu.ops.w4a8_fused import w4a8_layer_fused as jfused
from kvzip_tpu.ops.w4a8_v2 import repack_scales_v2
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch.engine import Engine, KVState
from kvzip_tpu_torch.models import transformer
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.ops.w4a8_fused import MAX_T, w4a8_layer_fused

from test_torch_engine import CTX, IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_engine_quant import QUANT, QUERY_Q, _carry_dense

L, D, I = 3, 256, 384
H, Hkv, Dh = 2, 1, 128
EPS = 1e-6
RTOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}  # of max |reference|


@pytest.fixture(scope="module")
def weights():
    """The reference's v2 weight stacks, quantized from numpy weights made
    from a seed, and the two norm stacks."""
    rng = np.random.default_rng(0)

    def quant(IN, OUT):
        w = jnp.asarray(rng.standard_normal((L, IN, OUT)) * 0.05, jnp.float32)
        return jax.device_get(repack_scales_v2(quantize_weight_int4(w), in_dim=IN))

    return dict(wo=quant(H * Dh, D), wgu=quant(D, 2 * I), wdn=quant(I, D),
                wqkv=quant(D, H * Dh + 2 * Hkv * Dh),
                lnm=rng.standard_normal((L, D)) * 0.1 + 1,
                lna=rng.standard_normal((L, D)) * 0.1 + 1)


def _port(tree, dtype):
    return params_from_jax(jax.device_get(tree), "cpu", dtype)


@pytest.fixture(scope="module")
def reference(weights):
    """The reference kernel's (x_new, qkv) on one 8-row input per dtype and
    layer; the T-row cases take its first T rows, which is what the
    reference computes for T rows (it pads them to 8 itself, and every row
    is normalized and quantized on its own)."""
    cache = {}

    def get(dtype, layer):
        if (dtype, layer) not in cache:
            jdt = getattr(jnp, dtype)
            rng = np.random.default_rng(7)
            x = jnp.asarray(rng.standard_normal((MAX_T, D)) * 0.3, jdt)
            attn = jnp.asarray(rng.standard_normal((MAX_T, H * Dh)) * 0.3, jdt)
            lnm = jnp.asarray(weights["lnm"], jdt)
            lna = jnp.asarray(weights["lna"], jdt)
            ws = [weights[n] for n in ("wo", "wgu", "wdn", "wqkv")]
            want = jfused(x, attn, lnm[:, None], lna[:, None], *ws, jnp.int32(layer),
                          eps=EPS, interpret=True)
            cache[dtype, layer] = (dict(x=x, attn=attn, lnm=lnm, lna=lna),
                                   [np.asarray(w, np.float32) for w in want])
        return cache[dtype, layer]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, L - 1])
@pytest.mark.parametrize("T", [1, 4, 8])
def test_plain_fused_layer_matches_reference_kernel(weights, reference, T, layer, dtype):
    tdt = getattr(torch, dtype)
    inputs, want = reference(dtype, layer)
    tree = _port({"layers": {n: weights[n] for n in ("wo", "wgu", "wdn", "wqkv")},
                  **{k: v[:T] if k in ("x", "attn") else v for k, v in inputs.items()}},
                 tdt)
    lw = tree["layers"]
    got = w4a8_layer_fused(tree["x"], tree["attn"], tree["lnm"], tree["lna"], lw["wo"],
                           lw["wgu"], lw["wdn"], lw["wqkv"], layer, eps=EPS)
    for g, w, name in zip(got, want, ("x", "qkv")):
        w = w[:T]
        assert g.dtype == tdt and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=RTOL[dtype] * np.abs(w).max(), err_msg=name)


def test_fused_layer_rejects_more_than_eight_rows(weights):
    tree = _port({n: weights[n] for n in ("wo", "wgu", "wdn", "wqkv")}, torch.float32)
    ln = torch.ones((L, D))
    with pytest.raises(ValueError, match="1..8"):
        w4a8_layer_fused(torch.zeros((9, D)), torch.zeros((9, H * Dh)), ln, ln,
                         tree["wo"], tree["wgu"], tree["wdn"], tree["wqkv"], 0, eps=EPS)


# ------------------------------------------------------------ end to end
SHAPE = dict(head_dim=128, num_heads=4, num_kv_heads=2, hidden_size=128, num_layers=2)
KW = dict(max_new_tokens=4, decode_budget=132, capacity_granularity=256,
          score_chunk_size=256)


@pytest.fixture(scope="module")
def carried():
    """The reference (int4 KV + W4A8 + int8 embedding, fuse_layer "on") and
    the port with its prepared parameters, both holding the reference's
    prefilled and scored state."""
    jcfg = tiny_config("qwen2", **SHAPE)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    # weights at 7x the init scale, as in test_torch_engine.py
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][name] = tree["layers"][name] * np.float32(7.0)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), **KW, **QUANT)
    jeng = JEngine("tiny-qwen2", config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    jeng.fuse_layer = "on"
    teng = Engine("tiny-qwen2", config=tconfig.tiny_config("qwen2", **SHAPE),
                  params=params_from_jax(jax.device_get(jeng.params), "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    jst = jeng.prefill(CTX[:700], prefill_chunk_size=256)
    tst = KVState(cache=_carry_dense(jst.cache), kv_type="evict", sink=jst.sink,
                  ctx_len=jst.ctx_len, prefill_len=jst.prefill_len,
                  score=torch.from_numpy(np.array(jst.score)))
    tst.snapshot()
    return jeng, teng, jst, tst


@pytest.fixture
def fused_calls(monkeypatch):
    """How many times the forward called the fused layer."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[8])
        return w4a8_layer_fused(*args, **kw)

    monkeypatch.setattr(transformer, "w4a8_layer_fused", counted)
    return calls


@pytest.mark.parametrize("layout", ["on", "legacy"], ids=["pool", "legacy_flat"])
def test_fused_greedy_tokens_match_reference(carried, layout, fused_calls, monkeypatch):
    """The port's fused tokens equal its composed ones and the reference's
    composed ones. The reference's fused route is held too, with its own
    choice of qkv weights: its forward passes ``layer`` where the next
    layer's qkv is made, so from the second layer on it attends with the
    previous layer's q/k/v weights and its tokens leave the composed ones;
    given that choice, the port's fused route gives the reference's fused
    tokens (checked on the pool; its interpret-mode compile is the costly
    part of this test)."""
    jeng, teng, jst, tst = carried
    jst, tst = copy.deepcopy(jst), copy.deepcopy(tst)  # the prune consumes the dense cache
    jeng.flat_decode = teng.flat_decode = layout
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    try:
        jeng.fuse_layer = "off"
        composed = jeng.generate(QUERY_Q, jst)
        teng.fuse_layer = "on"
        assert teng.generate(QUERY_Q, tst) == composed
        # every query chunk of <= 8 rows and every decode step, each layer
        assert len(fused_calls) >= 2 * SHAPE["num_layers"]
        assert set(fused_calls) == set(range(SHAPE["num_layers"]))
        n = len(fused_calls)
        teng.fuse_layer = "off"
        assert teng.generate(QUERY_Q, tst) == composed and len(fused_calls) == n
        if layout == "legacy":  # the reference's fused route once, on the pool
            return

        def reference_weights(*args, qkv_layer=None, **kw):
            return w4a8_layer_fused(*args, **kw)

        monkeypatch.setattr(transformer, "w4a8_layer_fused", reference_weights)
        jeng.fuse_layer = teng.fuse_layer = "on"
        reference_fused = jeng.generate(QUERY_Q, jst)
        assert teng.generate(QUERY_Q, tst) == reference_fused != composed
    finally:
        jeng.fuse_layer = "on"
        teng.fuse_layer = "off"


@pytest.mark.parametrize("weight_quant,kv_quant,fuse", [
    ("w4a8", "int4", "off"), ("w4a8", "int4", "auto"), ("w8a8", "int4", "on"),
    ("none", "none", "on")])
def test_fused_layer_runs_only_where_the_gate_allows(weight_quant, kv_quant, fuse,
                                                     fused_calls):
    """"auto" on the CPU, "off", W8A8 and plain weights never fuse; nor do
    prefill and scoring with "on" (checked before the prune)."""
    eng = Engine("tiny-qwen2", config=tconfig.tiny_config("qwen2", **SHAPE),
                 tokenizer=IdTokenizer(512), dtype=torch.float32, device="cpu",
                 weight_quant=weight_quant, kv_quant=kv_quant, **KW)
    eng.fuse_layer = "on"
    st = eng.prefill(CTX[:300], prefill_chunk_size=256)
    assert fused_calls == []
    eng.fuse_layer = fuse
    eng.prune(st, 0.3, "pair")
    assert len(eng.generate_ids(QUERY_Q, st)) > 0
    assert fused_calls == []


def test_bad_fuse_layer_value_raises(carried):
    _, teng, _, tst = carried
    teng.fuse_layer = "yes"
    try:
        with pytest.raises(ValueError, match="fuse_layer"):
            teng.generate_ids(QUERY_Q, copy.deepcopy(tst))
    finally:
        teng.fuse_layer = "off"
