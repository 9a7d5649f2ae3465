"""Parameter dictionaries: seeded random init, quantization policy and
import from the reference.

Same tree and layout as ``kvzip_tpu/models/params.py``: stacked per-layer
tensors with a leading ``L`` axis, linear weights stored ``(in, out)`` and
applied as ``x @ w``. Quantized weights are dicts: W4A8 v2 stacks
``{"q4", "s2", "z2"}`` (``ops/w4a8_v2.py``), W8A8 stacks ``{"q", "s"}``
with int8 bytes ``(L, out, in)`` and the int8 embedding / lm_head tables
``{"q", "s"}`` (``ops/quant.py``).
"""

from __future__ import annotations

from typing import Any, Dict

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


_BIG = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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


def quantize_layer_stacks(layers: dict, quant_fn) -> dict:
    """Quantize every float projection stack of a layer tree one layer at
    a time (the float32 temporaries stay one layer's size)."""
    out = dict(layers)
    for name in _BIG:
        w = layers.get(name)
        if w is None or isinstance(w, dict):
            continue
        parts = [quant_fn(w[l]) for l in range(w.shape[0])]
        out[name] = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    return out


def prepare_params(cfg: ModelConfig, params: Params = None, *, dtype,
                   weight_quant: str = "none", embed_quant: str = "none",
                   generator: torch.Generator = None, device="cuda") -> Params:
    """Quantization policy of the reference's ``prepare_params``: random
    init (from ``generator``) or passed-in params, times ``weight_quant``
    in {"none", "w8a8", "w4a8"} and ``embed_quant`` in {"none", "int8"}.
    W8A8 stacks are ``{"q", "s"}`` dicts stored ``(out, in)``; W4A8 stacks
    end fused (wqkv, w_gateup) and in v2 storage; checkpoint loading is not
    ported."""
    if weight_quant not in ("none", "w8a8", "w4a8"):
        raise NotImplementedError(f"weight_quant={weight_quant!r} is not ported")
    if embed_quant not in ("none", "int8"):
        raise NotImplementedError(f"embed_quant={embed_quant!r} is not ported")
    if params is None:
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
    if embed_quant == "int8" and not isinstance(params["embed"], dict):
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
