"""Decoder forward of the port: bf16 dense-cache and pool branches.

Port of ``kvzip_tpu/models/transformer.py::forward`` for the llama and
qwen2 families (GQA, RoPE, optional qkv bias) without weight quantization.
PyTorch runs eagerly, so the layer loop is a Python loop and the cache is
updated in place. Attention dispatch, as in the reference:

- dense cache: the KVzip score hook goes to K2 (``fused_scores``); T <= 8
  queries go to K4 (``ragged_decode_attend``), longer blocks to K1
  (``flash_attend``);
- pool cache: K3 (``pool_decode_attend``), after the T new rows are written
  into the full (L, Hkv, Tcap, D) tail stacks at ``tail_len``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from kvzip_tpu_torch.cache import append_layer
from kvzip_tpu_torch.config import ModelConfig
from kvzip_tpu_torch.models.rope import apply_rope, rope_cos_sin
from kvzip_tpu_torch.ops.flash import flash_attend
from kvzip_tpu_torch.ops.pool_decode import pool_decode_attend
from kvzip_tpu_torch.ops.ragged_decode import MAX_T, ragged_decode_attend
from kvzip_tpu_torch.ops.score_kernel import fused_scores
from kvzip_tpu_torch.pool import PoolKV


class ForwardResult(NamedTuple):
    logits: Optional[torch.Tensor]        # (T, V), (1, V) or None
    chunk_scores: Optional[torch.Tensor]  # (L, Hkv, score_width) or None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu_pytorch_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _lin(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    y = x @ w
    return y if bias is None else y + bias


def check_supported(cfg: ModelConfig) -> None:
    """The port's forward covers the llama and qwen2 families."""
    if (cfg.is_hybrid or cfg.qk_norm or cfg.post_norms
            or cfg.gemma_style_norm or cfg.rope_local is not None):
        raise NotImplementedError(
            f"{cfg.name}: only llama/qwen2-style decoders are ported")


def forward(params, cfg: ModelConfig, ids: torch.Tensor, cache, *,
            collect_logits: str = "none", scoring: bool = False,
            score_start: int = 0, score_len: int = 0, score_qlen: int = 0,
            score_width: int = 0, sink: int = 0) -> ForwardResult:
    """Run ids (T,) through the model, appending their KV to ``cache`` in
    place (``lengths``/``seen``, or ``tail_len``/``seen`` for a pool).

    ``collect_logits``: "none" | "last" | "all". ``scoring``: the KVzip
    repeat pass on a dense cache; ``score_start`` is the cache row of the
    scored ctx window, ``score_len`` its true length, ``score_qlen`` the
    true number of repeat queries.
    """
    T = ids.shape[0]
    L, H, Hkv, Dh = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    is_pool = isinstance(cache, PoolKV)
    if scoring and is_pool:
        raise ValueError("scoring runs before the prune; a pool is decode-only")
    if is_pool and cache.tail_len + T > cache.k_tail.shape[2]:
        raise ValueError("pool tail overflow")
    dtype = params["embed"].dtype

    x = params["embed"][ids]
    positions = torch.arange(cache.seen, cache.seen + T, device=ids.device)
    cos, sin = rope_cos_sin(cfg.rope, Dh, positions)
    lp_all = params["layers"]
    scores = []
    for l in range(L):
        lp = {k: v[l] for k, v in lp_all.items()}
        h = rms_norm(x, lp["ln_attn"], cfg.rms_norm_eps)
        q = _lin(h, lp["wq"], lp.get("bq")).view(T, H, Dh)
        k = _lin(h, lp["wk"], lp.get("bk")).view(T, Hkv, Dh)
        v = _lin(h, lp["wv"], lp.get("bv")).view(T, Hkv, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if is_pool:
            t0 = cache.tail_len
            cache.k_tail[l, :, t0:t0 + T] = k.transpose(0, 1)
            cache.v_tail[l, :, t0:t0 + T] = v.transpose(0, 1)
            attn = pool_decode_attend(
                q, cache.k_pool, cache.v_pool, cache.row_head,
                cache.layer_off, cache.layer_rows, cache.k_tail,
                cache.v_tail, t0, l, scale=scale, max_rows=cache.max_rows)
        else:
            k_l, v_l, base = cache.k[l], cache.v[l], cache.lengths[l]
            append_layer(k_l, v_l, base, k, v)
            if scoring:
                keys = torch.cat(
                    [k_l[:, :sink], k_l[:, score_start:score_start + score_width],
                     k.transpose(0, 1)], dim=1)
                scores.append(fused_scores(
                    q, keys, score_len, score_qlen, sink=sink,
                    s_ctx=score_width, scale=scale, model_dtype=dtype).to(dtype))
            if T <= MAX_T:
                attn = ragged_decode_attend(q, k_l, v_l, base, scale=scale)
            else:
                attn = flash_attend(q, k_l, v_l, base, scale=scale)

        x = x + _lin(attn.reshape(T, H * Dh), lp["wo"])
        h2 = rms_norm(x, lp["ln_mlp"], cfg.rms_norm_eps)
        hidden = _act(_lin(h2, lp["w_gate"]), cfg.hidden_act) * _lin(h2, lp["w_up"])
        x = x + _lin(hidden, lp["w_down"])

    if is_pool:
        cache.tail_len += T
    else:
        # stream-ordered after every kernel above that read the old lengths
        cache.lengths += T
    cache.seen += T

    logits = None
    if collect_logits != "none":
        xf = x if collect_logits == "all" else x[-1:]
        xf = rms_norm(xf, params["final_norm"], cfg.rms_norm_eps)
        logits = xf @ params.get("lm_head", params["embed"]).T
    return ForwardResult(logits, torch.stack(scores) if scoring else None)
