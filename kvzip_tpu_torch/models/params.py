"""Parameter dictionaries: seeded random init, HuggingFace safetensors
checkpoints, quantization policy and import from the reference.

Same tree and layout as ``kvzip_tpu/models/params.py``: stacked per-layer
tensors with a leading ``L`` axis, linear weights stored ``(in, out)`` and
applied as ``x @ w``. Quantized weights are dicts: W4A8 v1 stacks
``{"q4", "s", "z"}`` (``ops/w4a8.py``) or v2 ``{"q4", "s2", "z2"}``
(``ops/w4a8_v2.py``), W8A8 stacks ``{"q", "s"}`` with int8 bytes
``(L, out, in)``, the int8 embedding / lm_head tables ``{"q", "s"}`` and the
int4 lm_head (a one-layer v2 stack, ``ops/quant.py``).

Checkpoints are read by the port's own safetensors reader (``_read_raw``):
an 8-byte little-endian header length, a JSON header of names, dtypes,
shapes and byte offsets, then the raw little-endian tensors, mapped with
``numpy.memmap``; BF16 is read as uint16 and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from kvzip_tpu_torch.config import ModelConfig

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Params:
    """Random init at any width: N(0, 0.02) weights and biases, unit norms.

    ``generator`` must live on ``device``; weights are drawn one layer at a
    time so the float32 temporary stays one layer's size.
    """
    D, H, Hkv, Dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, I, V = cfg.num_layers, cfg.intermediate_size, cfg.vocab_size

    def nrm(*shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        for sl in (out if len(shape) == 3 else [out]):
            sl.copy_(torch.randn(sl.shape, generator=generator, device=device,
                                 dtype=torch.float32) * 0.02)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "wq": nrm(L, D, H * Dh), "wk": nrm(L, D, Hkv * Dh),
        "wv": nrm(L, D, Hkv * Dh), "wo": nrm(L, H * Dh, D),
        "w_gate": nrm(L, D, I), "w_up": nrm(L, D, I), "w_down": nrm(L, I, D),
        "ln_attn": ones(L, D), "ln_mlp": ones(L, D),
    }
    if cfg.attention_bias:
        layers.update(bq=nrm(L, H * Dh), bk=nrm(L, Hkv * Dh), bv=nrm(L, Hkv * Dh))
    params: Params = {"embed": nrm(V, D), "layers": layers,
                      "final_norm": ones(D)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm(V, D)
    return params


# the seven big projection stacks (everything else is norms and biases)
_BIG_SLOTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def init_params_w4a8(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda", dtype=torch.bfloat16) -> Params:
    """Random init directly in W4A8 (v1) form (int4 per-group weights)."""
    from kvzip_tpu_torch.ops.w4a8 import quantize_weight_int4

    return _init_params_quantized(cfg, generator, device, dtype,
                                  quantize_weight_int4)


def init_params_w8a8(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda", dtype=torch.bfloat16) -> Params:
    """Random init directly in W8A8 form (int8 per-channel weights, stored
    ``(out, in)``); embedding and lm_head stay in ``dtype``, as in QServe."""
    from kvzip_tpu_torch.ops.quant import quantize_weight_int8

    return _init_params_quantized(cfg, generator, device, dtype,
                                  quantize_weight_int8)


def _init_params_quantized(cfg: ModelConfig, generator: torch.Generator,
                           device, dtype, quant_fn) -> Params:
    """Each layer's N(0, 0.02) weight is drawn, rounded to ``dtype`` and
    quantized by ``quant_fn`` before the next, so no float stack is ever
    resident (a (32, 4096, 14336) float32 stack is 7.5 GB). Biases are zero
    and norms one, as in the reference's quantized init."""
    D, H, Hkv, Dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, I, V = cfg.num_layers, cfg.intermediate_size, cfg.vocab_size
    shapes = {"wq": (D, H * Dh), "wk": (D, Hkv * Dh), "wv": (D, Hkv * Dh),
              "wo": (H * Dh, D), "w_gate": (D, I), "w_up": (D, I),
              "w_down": (I, D)}

    def nrm(*shape):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)

    layers = {}
    for name, shape in shapes.items():
        parts = [quant_fn(nrm(*shape)) for _ in range(L)]
        layers[name] = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        del parts
    layers["ln_attn"] = torch.ones((L, D), dtype=dtype, device=device)
    layers["ln_mlp"] = torch.ones((L, D), dtype=dtype, device=device)
    if cfg.attention_bias:
        for b, n in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            layers[b] = torch.zeros((L, n), dtype=dtype, device=device)
    params: Params = {"embed": nrm(V, D), "layers": layers,
                      "final_norm": torch.ones((D,), dtype=dtype, device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = nrm(V, D)
    return params


def _cat_parts(parts: list) -> dict:
    """Chunks of quantized dicts, concatenated along the layer axis."""
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def quantize_layer_stacks(layers: dict, quant_fn, chunk_layers: int = 1) -> dict:
    """Quantize every float projection stack of a layer tree,
    ``chunk_layers`` layers at a time, by default one (the float32
    temporaries stay one chunk's size)."""
    out = dict(layers)
    for name in _BIG_SLOTS:
        w = layers.get(name)
        if w is None or isinstance(w, dict):
            continue
        out[name] = _cat_parts([quant_fn(w[l0:l0 + chunk_layers])
                                for l0 in range(0, w.shape[0], chunk_layers)])
    return out


# ----------------------------------------------------------- checkpoints
_ST_DTYPES = {"BF16": "<u2", "F16": "<f2", "F32": "<f4", "F64": "<f8", "I8": "i1",
              "U8": "u1", "I16": "<i2", "U16": "<u2", "I32": "<i4", "U32": "<u4",
              "I64": "<i8", "U64": "<u8", "BOOL": "?"}
_WANTED_PREFIXES = ("model.", "lm_head.", "language_model.")

RawTensors = Dict[str, Tuple[np.ndarray, str]]


def _read_header(path: str) -> Tuple[dict, int]:
    """A safetensors file's header (name -> dtype, shape, data_offsets)
    and the byte offset of its data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _checkpoint_files(ckpt_dir: str) -> list:
    files = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {ckpt_dir}")
    return files


def _read_raw(ckpt_dir: str) -> RawTensors:
    """Every model tensor of a safetensors checkpoint directory, as
    ``name -> (memory-mapped array, safetensors dtype)``; BF16 arrays hold
    the raw uint16 bits. Nothing is copied until a tensor is used."""
    raw: RawTensors = {}
    for path in _checkpoint_files(ckpt_dir):
        header, start = _read_header(path)
        data = np.memmap(path, dtype=np.uint8, mode="r")
        for name, info in header.items():
            if not name.startswith(_WANTED_PREFIXES):
                continue
            b0, b1 = info["data_offsets"]
            arr = data[start + b0:start + b1].view(np.dtype(_ST_DTYPES[info["dtype"]]))
            raw[name.replace("language_model.", "")] = (arr.reshape(info["shape"]),
                                                        info["dtype"])
    return raw


def _host_tensor(raw: RawTensors, name: str) -> torch.Tensor:
    """One checkpoint tensor copied into a host torch tensor, BF16 as
    ``torch.bfloat16``."""
    arr, st_dtype = raw[name]
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if st_dtype == "BF16" else t


def checkpoint_is_w8a8(ckpt_dir: str) -> bool:
    """True when the checkpoint stores pre-quantized int8 projection
    weights (QServe's ``*-w8a8kv4-per-channel`` layout)."""
    for path in _checkpoint_files(ckpt_dir):
        header, _ = _read_header(path)
        for name in sorted(header):
            if name.endswith("_proj.weight"):
                return header[name]["dtype"] == "I8"
    return False


# HF tensor name -> (slot, needs_transpose) for one layer
_LAYER_MAP = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "input_layernorm.weight": ("ln_attn", False),
    "post_attention_layernorm.weight": ("ln_mlp", False),
    # gemma3: HF's post_attention_layernorm is applied to the attention
    # output (ln_post_attn) and pre/post_feedforward around the MLP
    "pre_feedforward_layernorm.weight": ("ln_mlp_pre", False),
    "post_feedforward_layernorm.weight": ("ln_post_mlp", False),
}


def _stack_to(parts: list, device, dtype) -> torch.Tensor:
    """Host tensors of one shape stacked into one (len(parts), ...) tensor
    of ``dtype`` on ``device``, copied in one at a time."""
    out = torch.empty((len(parts), *parts[0].shape), dtype=dtype, device=device)
    for i, t in enumerate(parts):
        out[i].copy_(t)
    return out


def load_hf_params(cfg: ModelConfig, ckpt_dir: str, dtype=torch.bfloat16,
                   weight_quant: str = "none", chunk_layers: int = 4,
                   device="cuda") -> Params:
    """A HuggingFace safetensors checkpoint directory as the parameter
    tree (the llama/qwen2/qwen3/gemma3 text families' names).

    ``weight_quant`` "w8a8" or "w4a8" stream-quantizes the projection
    stacks: they stay on the host until their ``chunk_layers``-layer chunk
    goes to the device in ``dtype`` and is quantized there, so a 7B bf16
    checkpoint never has its full float stacks on the device. "w4a8" gives
    the unfused v1 stacks."""
    from kvzip_tpu_torch.ops.quant import quantize_weight_int8
    from kvzip_tpu_torch.ops.w4a8 import quantize_weight_int4

    quant_fns = {"none": None, "w8a8": quantize_weight_int8, "w4a8": quantize_weight_int4}
    if weight_quant not in quant_fns:
        raise ValueError(f"weight_quant: {weight_quant!r}")
    quant_fn = quant_fns[weight_quant]
    raw = _read_raw(ckpt_dir)
    stacks: Dict[str, list] = {}
    for l in range(cfg.num_layers):
        for suffix, (slot, transpose) in _LAYER_MAP.items():
            name = f"model.layers.{l}.{suffix}"
            if name in raw:
                t = _host_tensor(raw, name)
                stacks.setdefault(slot, []).append(t.T if transpose else t)
    layers: Dict[str, Any] = {}
    for slot, parts in stacks.items():
        if quant_fn is not None and slot in _BIG_SLOTS:
            layers[slot] = _stream_quantize_stack(parts, quant_fn, dtype, chunk_layers,
                                                  device)
        else:
            layers[slot] = _stack_to(parts, device, dtype)
    if cfg.post_norms and "ln_mlp_pre" in layers:
        layers["ln_post_attn"] = layers.pop("ln_mlp")
        layers["ln_mlp"] = layers.pop("ln_mlp_pre")
    return _tree(cfg, raw, layers, device, dtype)


def _tree(cfg: ModelConfig, raw: RawTensors, layers: dict, device, dtype) -> Params:
    """The layer stacks with the checkpoint's embedding, final norm and
    (untied) lm_head in ``dtype``; some checkpoints (gemma3, small qwen3)
    omit a tied lm_head."""
    def get(name):
        return _host_tensor(raw, name).to(device=device, dtype=dtype)

    params: Params = {"embed": get("model.embed_tokens.weight"), "layers": layers,
                      "final_norm": get("model.norm.weight")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in raw:
        params["lm_head"] = get("lm_head.weight")
    return params


def _stream_quantize_stack(host_parts: list, quant_fn, dtype, chunk_layers: int,
                           device) -> dict:
    """Per-layer host tensors quantized ``chunk_layers`` at a time on the
    device: its peak is the quantized stack plus one chunk and its float32
    temporaries."""
    return _cat_parts([quant_fn(_stack_to(host_parts[l0:l0 + chunk_layers], device, dtype))
                       for l0 in range(0, len(host_parts), chunk_layers)])


# per-linear scale-tensor suffixes seen across QServe-style exports
_W8A8_SCALE_SUFFIXES = ("dequant_scale", "weight_scale", "s1_scale", "scales")

# HF projection -> stacked slot (weights land as {"q": int8, "s": float32})
_W8A8_LAYER_MAP = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}

# tensors QServe keeps in floating point
_W8A8_FLOAT_MAP = {
    "input_layernorm.weight": "ln_attn",
    "post_attention_layernorm.weight": "ln_mlp",
    "self_attn.q_proj.bias": "bq",
    "self_attn.k_proj.bias": "bk",
    "self_attn.v_proj.bias": "bv",
}


def load_hf_params_w8a8(cfg: ModelConfig, ckpt_dir: str, dtype=torch.bfloat16,
                        device="cuda") -> Params:
    """A QServe-style pre-quantized W8A8 checkpoint: per linear an int8
    ``.weight`` (out, in) and a per-output-channel scale tensor (suffix
    ``dequant_scale``, ``weight_scale``, ``s1_scale`` or ``scales``);
    floating embedding, norms and lm_head. The int8 bytes keep HF's
    ``(out, in)``, which is the port's W8A8 layout ``{"q": (L, out, in)
    int8, "s": (L, out) float32}``."""
    raw = _read_raw(ckpt_dir)

    def find_scale(prefix: str) -> torch.Tensor:
        for suffix in _W8A8_SCALE_SUFFIXES:
            if f"{prefix}.{suffix}" in raw:
                return _host_tensor(raw, f"{prefix}.{suffix}").reshape(-1)
        raise KeyError(f"no dequant scale for {prefix} (tried {_W8A8_SCALE_SUFFIXES})")

    q: Dict[str, list] = {}
    scales: Dict[str, list] = {}
    floats: Dict[str, list] = {}
    for l in range(cfg.num_layers):
        prefix = f"model.layers.{l}."
        for hf_name, slot in _W8A8_LAYER_MAP.items():
            wname = f"{prefix}{hf_name}.weight"
            if wname not in raw:
                raise KeyError(f"missing {wname}")
            w = _host_tensor(raw, wname)
            if w.dtype != torch.int8:
                raise TypeError(f"{wname}: expected int8, got {w.dtype}")
            sc = find_scale(prefix + hf_name)
            if sc.shape[0] != w.shape[0]:
                raise ValueError(f"{wname}: scale length {sc.shape[0]} != out dim "
                                 f"{w.shape[0]}")
            q.setdefault(slot, []).append(w)
            scales.setdefault(slot, []).append(sc)
        for hf_name, slot in _W8A8_FLOAT_MAP.items():
            if prefix + hf_name in raw:
                floats.setdefault(slot, []).append(_host_tensor(raw, prefix + hf_name))
    layers: Dict[str, Any] = {
        slot: {"q": _stack_to(q[slot], device, torch.int8),
               "s": _stack_to(scales[slot], device, torch.float32)} for slot in q}
    layers.update({slot: _stack_to(parts, device, dtype) for slot, parts in floats.items()})
    return _tree(cfg, raw, layers, device, dtype)


def _is_checkpoint(model_name: str) -> bool:
    """True for a directory holding ``*.safetensors`` files."""
    return bool(model_name) and os.path.isdir(model_name) and bool(
        glob.glob(os.path.join(model_name, "*.safetensors")))


def prepare_params(cfg: ModelConfig, params: Params = None, *, dtype,
                   weight_quant: str = "none", embed_quant: str = "none",
                   generator: torch.Generator = None, device="cuda",
                   model_name: str = "") -> Params:
    """Loader policy of the reference's ``prepare_params``: a checkpoint
    directory (``model_name``), random init (from ``generator``) or
    passed-in params, times ``weight_quant`` in {"none", "w8a8", "w4a8"}
    and ``embed_quant`` in {"none", "int8", "int4h"}. A pre-quantized W8A8
    checkpoint loads as W8A8 whatever ``weight_quant`` asks. W8A8 stacks are
    ``{"q", "s"}`` dicts stored ``(out, in)``; ``weight_quant="w4a8"``
    stacks end fused (wqkv, w_gateup) and in v2 storage; a v1 tree passed
    with ``"none"`` stays as it is."""
    if weight_quant not in ("none", "w8a8", "w4a8"):
        raise NotImplementedError(f"weight_quant={weight_quant!r} is not ported")
    if embed_quant not in ("none", "int8", "int4h"):
        raise NotImplementedError(f"embed_quant={embed_quant!r} is not ported")
    if params is None and _is_checkpoint(model_name):
        if checkpoint_is_w8a8(model_name):
            params = load_hf_params_w8a8(cfg, model_name, dtype, device=device)
            weight_quant = "w8a8"
        else:
            params = load_hf_params(cfg, model_name, dtype, weight_quant=weight_quant,
                                    device=device)
    elif params is None:
        init = {"w4a8": init_params_w4a8, "w8a8": init_params_w8a8}.get(
            weight_quant, init_params)
        params = init(cfg, generator, device, dtype)
    if weight_quant == "w8a8" and not isinstance(params["layers"].get("wq"), dict):
        from kvzip_tpu_torch.ops.quant import quantize_params_w8a8

        params = quantize_params_w8a8(params)
    if weight_quant == "w4a8":
        from kvzip_tpu_torch.ops.w4a8 import fuse_w4a8_params, quantize_weight_int4
        from kvzip_tpu_torch.ops.w4a8_v2 import repack_w4a8_layers

        params = dict(params)
        lp = dict(params["layers"])
        if not isinstance(lp.get("wq"), dict) and "wqkv" not in lp:
            lp = quantize_layer_stacks(lp, quantize_weight_int4)
        lp = fuse_w4a8_params(lp)
        D, I = cfg.hidden_size, cfg.intermediate_size
        att = cfg.num_heads * cfg.head_dim
        params["layers"] = repack_w4a8_layers(
            lp, {"wqkv": D, "wq": D, "wk": D, "wv": D, "wo": att,
                 "w_gateup": D, "w_gate": D, "w_up": D, "w_down": I})
    if embed_quant == "int4h":
        # int8 embedding and an int4 lm_head (K8 on the card)
        from kvzip_tpu_torch.ops.quant import quantize_embed_int8, quantize_head_int4

        if "lm_head" not in params:
            raise ValueError(
                "embed_quant='int4h' needs an untied lm_head (int4 input embeddings "
                "would degrade token representations); use 'int8' for tied-embedding "
                "models")
        params = dict(params)
        if not isinstance(params["lm_head"], dict):
            params["lm_head"] = quantize_head_int4(params["lm_head"], dtype)
        if not isinstance(params["embed"], dict):
            params["embed"] = quantize_embed_int8(params["embed"], dtype)
    elif embed_quant == "int8" and not isinstance(params["embed"], dict):
        from kvzip_tpu_torch.ops.quant import quantize_embed_int8

        params = dict(params)
        params["embed"] = quantize_embed_int8(params["embed"], dtype)
        if "lm_head" in params:
            params["lm_head"] = quantize_embed_int8(params["lm_head"], dtype)
    return params


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    """A numpy array as a torch tensor; floating arrays cast to ``dtype``
    (None keeps theirs), integer arrays keep their dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native torch view
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is None or not t.is_floating_point():
        return t.to(device=device)
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree: Params, device="cuda", dtype=torch.bfloat16) -> Params:
    """The reference's parameter tree, given as numpy arrays (for example
    ``jax.device_get(params)``), as torch tensors in the same layout, except
    that W8A8 layer weights' int8 bytes go from the reference's ``(L, in,
    out)`` to the port's ``(L, out, in)``. Floating weights cast to
    ``dtype``; integer leaves (packed int4 bytes, int8 tables) keep their
    dtype, and every leaf of a quantized dict (``{"q4", ...}``,
    ``{"q", "s"}``) carries across with its dtype."""
    from kvzip_tpu_torch.ops.quant import is_w8

    out = _from_jax(tree, device, dtype)
    if isinstance(out, dict) and isinstance(out.get("layers"), dict):
        for w in out["layers"].values():
            if is_w8(w):
                w["q"] = w["q"].transpose(-1, -2).contiguous()
    return out


def _from_jax(tree, device, dtype):
    if isinstance(tree, dict):
        quantized = "q4" in tree or "q" in tree
        return {k: _from_jax(v, device, None if quantized else dtype)
                for k, v in tree.items()}
    return _tensor(tree, device, dtype)
