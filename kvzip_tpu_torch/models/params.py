"""Parameter dictionaries: seeded random init and import from the reference.

Same tree and layout as ``kvzip_tpu/models/params.py``: stacked per-layer
tensors with a leading ``L`` axis, linear weights stored ``(in, out)`` and
applied as ``x @ w``.
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


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native torch view
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree: Params, device="cuda", dtype=torch.bfloat16) -> Params:
    """The reference's parameter tree, given as numpy arrays (for example
    ``jax.device_get(params)``), as torch tensors in the same layout."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)
