"""Checkpoint loading of the port against the JAX package, on the CPU, on a
tiny qwen2 checkpoint this module writes with ``safetensors.numpy`` in
HuggingFace's names (``config.json`` and two shards, bf16), and on its
QServe-style W8A8 export (int8 projections, per-channel
``dequant_scale``), as ``tests/test_w8a8_loader.py`` builds them.

Held: the port's own safetensors reader against ``safetensors.safe_open``
(every dtype the loaders meet, the name filter); ``chip_smoke.py``'s
writer read back by ``safe_open``; ``checkpoint_is_w8a8``;
``load_hf_params`` with weight_quant none, w8a8 and w4a8 (the port
quantizing one layer a chunk, the reference four) and
``load_hf_params_w8a8`` leaf for leaf and bit for bit (the W8A8 int8 bytes
transposed to the port's ``(L, out, in)``), except that the reference's
streamed W8A8 scales, made under ``jax.jit``, may sit one float32 ulp off
(there the port's equal the reference's eager ``quantize_weight_int8``
bit for bit); ``Engine(<dir>)`` of both
packages (config from ``config.json``, the same prepared tree bit for bit,
the same greedy tokens from the reference's dense cache, as
``tests/test_torch_engine_w8a8.py`` carries it) and on the W8A8 export.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file

import chip_smoke
from kvzip_tpu.config import ModelConfig as JModelConfig
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.ops import quant as jquant
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.models import params
from kvzip_tpu_torch.ops.quant import is_w8

from test_torch_engine import IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_engine_quant import CTX_Q, QUERY_Q
from test_torch_engine_w8a8 import _carry
from test_torch_quant import _t

CONFIG = dict(model_type="qwen2", vocab_size=256, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
              tie_word_embeddings=False, hidden_act="silu")
PROJS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
         "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _hf_tensors(seed: int = 0) -> dict:
    """A tiny qwen2's tensors in HF names and (out, in) layout, float32."""
    rng = np.random.default_rng(seed)
    D, I, V = CONFIG["hidden_size"], CONFIG["intermediate_size"], CONFIG["vocab_size"]
    kv = CONFIG["num_key_value_heads"] * D // CONFIG["num_attention_heads"]
    shapes = {"self_attn.q_proj.weight": (D, D), "self_attn.k_proj.weight": (kv, D),
              "self_attn.v_proj.weight": (kv, D), "self_attn.o_proj.weight": (D, D),
              "self_attn.q_proj.bias": (D,), "self_attn.k_proj.bias": (kv,),
              "self_attn.v_proj.bias": (kv,), "mlp.gate_proj.weight": (I, D),
              "mlp.up_proj.weight": (I, D), "mlp.down_proj.weight": (D, I),
              "input_layernorm.weight": (D,), "post_attention_layernorm.weight": (D,)}
    out = {"model.embed_tokens.weight": rng.standard_normal((V, D)) * 0.05,
           "model.norm.weight": 1 + 0.1 * rng.standard_normal(D),
           "lm_head.weight": rng.standard_normal((V, D)) * 0.05}
    for l in range(CONFIG["num_hidden_layers"]):
        for suffix, shape in shapes.items():
            scale = 0.1 if "norm" in suffix else 0.15
            base = 1.0 if "norm" in suffix else 0.0
            out[f"model.layers.{l}.{suffix}"] = base + scale * rng.standard_normal(shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _save(dst: str, tensors: dict) -> None:
    """``config.json`` and two shards (layer 0 and the embedding, the rest)."""
    os.makedirs(dst, exist_ok=True)
    first = {k: v for k, v in tensors.items() if k.startswith(("model.layers.0.", "model.embed"))}
    rest = {k: v for k, v in tensors.items() if k not in first}
    save_file(first, os.path.join(dst, "model-00001-of-00002.safetensors"))
    save_file(rest, os.path.join(dst, "model-00002-of-00002.safetensors"))
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(CONFIG, f)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(bf16 checkpoint dir, its W8A8 export dir)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    src = _hf_tensors()
    bf16 = {k: v.astype(ml_dtypes.bfloat16) for k, v in src.items()}
    w8 = {}
    for k, v in bf16.items():
        if any(k.endswith(p + ".weight") for p in PROJS):
            w = v.astype(np.float32)
            s = np.abs(w).max(axis=1) / 127.0 + 1e-8
            w8[k] = np.clip(np.round(w / s[:, None]), -127, 127).astype(np.int8)
            w8[k.replace(".weight", ".dequant_scale")] = s.astype(np.float32)
        else:
            w8[k] = v
    _save(str(tmp / "qwen2-bf16"), bf16)
    _save(str(tmp / "qwen2-w8a8"), w8)
    return str(tmp / "qwen2-bf16"), str(tmp / "qwen2-w8a8")


def _cfgs(path):
    from kvzip_tpu_torch.config import ModelConfig

    cfg_json = os.path.join(path, "config.json")
    return (JModelConfig.from_json(cfg_json, name="tiny-qwen2"),
            ModelConfig.from_json(cfg_json, name="tiny-qwen2"))


def _same_tree(got, want, path="", scale_ulps=0):
    """Every leaf equal, dtype and bits; W8A8 int8 bytes of the reference
    transposed to the port's (L, out, in); W8A8 layer scales within
    ``scale_ulps`` float32 ulps."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}", scale_ulps)
        return
    want = _t(want)
    if path.endswith("/q") and want.dtype == torch.int8 and "/layers/" in path:
        want = want.transpose(-1, -2)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    if scale_ulps and path.endswith("/s") and "/layers/" in path:
        ulps = (got.view(torch.int32) - want.view(torch.int32)).abs().max().item()
        assert ulps <= scale_ulps, (path, ulps)
        return
    assert torch.equal(got, want), path


def test_reader_matches_safe_open(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"model.a": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
              "model.b": rng.standard_normal((4,)).astype(np.float16),
              "model.c": rng.standard_normal((2, 3, 2)).astype(np.float32),
              "model.d": rng.integers(-128, 128, (6, 7)).astype(np.int8),
              "model.e": rng.integers(0, 256, (5,)).astype(np.uint8),
              "model.f": rng.integers(-2 ** 31, 2 ** 31, (3,)).astype(np.int32),
              "lm_head.weight": rng.standard_normal((2, 8)).astype(np.float32),
              "language_model.model.g": rng.standard_normal((2,)).astype(np.float32),
              "other.h": np.zeros((2,), np.float32)}
    save_file(dict(list(arrays.items())[:4]), str(tmp_path / "a.safetensors"))
    save_file(dict(list(arrays.items())[4:]), str(tmp_path / "b.safetensors"))
    raw = params._read_raw(str(tmp_path))
    assert sorted(raw) == sorted(["model.a", "model.b", "model.c", "model.d", "model.e",
                                  "model.f", "lm_head.weight", "model.g"])
    for f in ("a", "b"):
        with safe_open(str(tmp_path / f"{f}.safetensors"), framework="np") as st:
            for name in st.keys():
                if name == "other.h":
                    continue
                want = st.get_tensor(name)
                got = params._host_tensor(raw, name.replace("language_model.", ""))
                if want.dtype.name == "bfloat16":
                    assert got.dtype == torch.bfloat16
                    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                                  want.view(np.int16))
                else:
                    np.testing.assert_array_equal(got.numpy(), want)


def test_smoke_writer_reads_back_with_safe_open(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"x.bf16": torch.randn(3, 4, generator=g).to(torch.bfloat16),
               "x.f32": torch.randn(5, generator=g),
               "x.i8": torch.randint(-127, 128, (2, 3), generator=g, dtype=torch.int8)}
    path = str(tmp_path / "w.safetensors")
    chip_smoke.write_safetensors(path, tensors)
    with safe_open(path, framework="pt") as st:
        assert sorted(st.keys()) == sorted(tensors)
        for name, t in tensors.items():
            assert torch.equal(st.get_tensor(name), t), name


def test_checkpoint_is_w8a8_matches_reference(ckpts):
    for path, want in zip(ckpts, (False, True)):
        assert params.checkpoint_is_w8a8(path) is jparams.checkpoint_is_w8a8(path) is want


@pytest.mark.parametrize("weight_quant", ["none", "w8a8", "w4a8"])
def test_load_hf_params_matches_reference(ckpts, weight_quant):
    jcfg, tcfg = _cfgs(ckpts[0])
    jdtype, tdtype = ((jnp.float32, torch.float32) if weight_quant == "none"
                      else (jnp.bfloat16, torch.bfloat16))
    want = jax.device_get(jparams.load_hf_params(jcfg, ckpts[0], dtype=jdtype,
                                                 weight_quant=weight_quant))
    got = params.load_hf_params(tcfg, ckpts[0], tdtype, weight_quant=weight_quant,
                                chunk_layers=1, device="cpu")
    if weight_quant != "w8a8":
        _same_tree(got, want)
        return
    # the reference's loader quantizes under jit, where XLA divides by 127
    # through a reciprocal: its scales sit one ulp from its own eager
    # quantize_weight_int8, which the port's equal bit for bit
    _same_tree(got, want, scale_ulps=1)
    full = jparams.load_hf_params(jcfg, ckpts[0], dtype=jnp.bfloat16)
    for n in params._BIG_SLOTS:
        eager = jax.device_get(jquant.quantize_weight_int8(full["layers"][n]))
        _same_tree(got["layers"][n], eager, f"/layers/{n}")


def test_load_hf_params_w8a8_matches_reference(ckpts):
    jcfg, tcfg = _cfgs(ckpts[1])
    want = jax.device_get(jparams.load_hf_params_w8a8(jcfg, ckpts[1], dtype=jnp.float32))
    got = params.load_hf_params_w8a8(tcfg, ckpts[1], torch.float32, device="cpu")
    _same_tree(got, want)
    assert all(is_w8(got["layers"][n]) for n in params._BIG_SLOTS)


def test_engine_loads_a_checkpoint_dir_as_the_reference(ckpts):
    """``Engine(<dir>, weight_quant="w4a8")``: the config from
    ``config.json``, the streamed, fused and repacked tree equal to the
    reference's, the same answers from one dense state; the W8A8 export
    loads as W8A8 whatever ``weight_quant`` asks, and answers."""
    bf16, w8 = ckpts
    kw = dict(tokenizer=IdTokenizer(CONFIG["vocab_size"]), max_new_tokens=4,
              decode_budget=132, capacity_granularity=256, score_chunk_size=256)
    jeng = JEngine(bf16, dtype=jnp.float32, flat_decode="on", weight_quant="w4a8", **kw)
    teng = Engine(bf16, dtype=torch.float32, device="cpu", weight_quant="w4a8", **kw)
    assert teng.config.hidden_size == 128 and teng.config.attention_bias
    assert teng.config.num_layers == jeng.config.num_layers == 2
    _same_tree(teng.params, jax.device_get(jeng.params))
    assert "s2" in teng.params["layers"]["wqkv"] and "wq" not in teng.params["layers"]
    jst = jeng.prefill(CTX_Q, prefill_chunk_size=256)
    tst = _carry(jst, teng.prefill(CTX_Q, prefill_chunk_size=256))
    assert teng.generate(QUERY_Q, tst) == jeng.generate(QUERY_Q, jst)

    weng = Engine(w8, dtype=torch.float32, device="cpu", weight_quant="w4a8", **kw)
    jcfg, _ = _cfgs(w8)
    _same_tree(weng.params["layers"],
               jax.device_get(jparams.load_hf_params_w8a8(jcfg, w8, jnp.float32))["layers"],
               "/layers")
    wst = weng.prefill(CTX_Q, prefill_chunk_size=256)
    assert len(weng.generate_ids(QUERY_Q, wst)) > 0
