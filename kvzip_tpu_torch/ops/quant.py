"""Quantization ops of the port: int4 KV, per-token int8 activations, W8A8
linears and the int8 embedding / lm_head tables.

Port of ``kvzip_tpu/ops/quant.py`` (int4 KV, ``quantize_act_int8``, W8A8,
the int8 embed and head, the int4 head). The int4 KV semantics: per group of 128 contiguous head-dim
elements, ``scale = (max - min) / 15 + 1e-8``, ``zero = min``,
``q = clamp(round((x - zero) / scale), 0, 15)``, two nibbles per byte. The
scale is computed in float32 and used unrounded to pick the nibble, then
stored in the input's dtype, so bytes and stored scales are bit-identical
to the JAX package's.

W8A8 (QServe's per-channel int8 weights, per-token int8 activations): a
weight is stored as ``{"q": int8 (..., out, in), "s": float32 (..., out)}``,
the transpose of the reference's ``(in, out)`` bytes, so that on the card
``torch._int_mm`` takes ``q.T`` as its column-major operand, as the int8
lm_head does. The reference leaves the int8 product to XLA outside any
Pallas kernel; the port leaves it to ``torch._int_mm``.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT4_GROUP = 128
EPS = 1e-8


def quantize_int4(x: torch.Tensor, group_size: int = INT4_GROUP,
                  pack: str = "pairs"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., D) -> packed (..., D//2) uint8, scale/zero (..., D//g) in
    x's dtype.

    pack="pairs": element 2j in the high nibble, 2j+1 low. pack="split":
    element j high, j + D/2 low (the layout of the int4 caches).
    """
    *lead, D = x.shape
    g = min(group_size, D)
    xg = x.reshape(*lead, D // g, g).float()
    mn = xg.amin(dim=-1)
    mx = xg.amax(dim=-1)
    scale = (mx - mn) / 15.0 + EPS
    zero = mn
    q = torch.clamp(torch.round((xg - zero[..., None]) / scale[..., None]), 0, 15)
    q = q.to(torch.uint8).reshape(*lead, D)
    if pack == "pairs":
        packed = (q[..., 0::2] << 4) | q[..., 1::2]
    else:
        half = D // 2
        packed = (q[..., :half] << 4) | q[..., half:]
    return packed, scale.to(x.dtype), zero.to(x.dtype)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, out_dtype=torch.bfloat16,
                    pack: str = "pairs") -> torch.Tensor:
    """packed (..., D//2) + scale/zero (..., D//g) -> (..., D), computed in
    float32."""
    hi = (packed >> 4).to(torch.int32)
    lo = (packed & 0xF).to(torch.int32)
    if pack == "pairs":
        q = torch.stack([hi, lo], dim=-1).reshape(*packed.shape[:-1],
                                                  packed.shape[-1] * 2)
    else:
        q = torch.cat([hi, lo], dim=-1)
    D = q.shape[-1]
    g = D // scale.shape[-1]
    qg = q.reshape(*packed.shape[:-1], D // g, g)
    x = qg.float() * scale[..., None].float() + zero[..., None].float()
    return x.reshape(*packed.shape[:-1], D).to(out_dtype)


def quantize_act_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8: x (T, IN) -> (int8 (T, IN),
    float32 scales (T, 1))."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + EPS
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def is_w8(w) -> bool:
    """True for a W8A8 weight dict (``{"q", "s"}``, not W4A8's ``q4``)."""
    return isinstance(w, dict) and "q" in w and "q4" not in w


def quantize_weight_int8(w: torch.Tensor) -> dict:
    """w (..., in, out) float -> {"q": int8 (..., out, in), "s": float32
    (..., out)}: per output channel, ``s = amax / 127 + EPS``,
    ``q = clamp(round(w / s), -127, 127)``."""
    wf = w.float()
    s = wf.abs().amax(dim=-2) / 127.0 + EPS
    q = torch.clamp(torch.round(wf / s[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q.transpose(-1, -2).contiguous(), "s": s}


def int8_matmul(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                ws: torch.Tensor, bias=None, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """Pre-quantized activations xq (T, in) int8 with scales xs (T, 1) times
    wq (out, in) int8 with scales ws (out,): the exact int32 product, then
    ``acc * xs * ws`` (+ bias) in float32, cast to ``out_dtype``."""
    acc = _int8_rows_dot(xq, wq)
    out = acc.float() * xs * ws[None, :]
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias=None) -> torch.Tensor:
    """Dynamic per-token activation quantization, then :func:`int8_matmul`;
    x (T, in) of any float dtype, which the output keeps."""
    xq, xs = quantize_act_int8(x)
    return int8_matmul(xq, xs, wq, ws, bias, x.dtype)


def quantize_params_w8a8(params: dict) -> dict:
    """Every float projection stack (L, in, out) of the layer tree as a W8
    dict, one layer at a time. Embedding, lm_head, norms and biases stay as
    they are, as in QServe."""
    from kvzip_tpu_torch.models.params import quantize_layer_stacks

    return {**params, "layers": quantize_layer_stacks(params["layers"],
                                                      quantize_weight_int8)}


def quantize_embed_int8(w: torch.Tensor, model_dtype=torch.bfloat16) -> dict:
    """Embedding / lm_head table (V, D) -> {"q": int8 (V, D), "s": (V,)}
    with one scale per vocab row."""
    wf = w.float()
    s = wf.abs().amax(dim=-1) / 127.0 + EPS
    q = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(model_dtype)}


def embed_lookup(emb, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup for a plain or int8-quantized embedding table."""
    if isinstance(emb, dict):
        return emb["q"][ids].to(emb["s"].dtype) * emb["s"][ids][:, None]
    return emb[ids]


def _int8_rows_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact xq (T, D) . wq (V, D)^T of int8 operands as int32 (T, V).

    On the card through ``torch._int_mm``, which takes more than 16 rows
    and dims that are multiples of 8: T is padded with zero rows and the
    result sliced. On the CPU a float64 product, exact for D < 2^39."""
    T = xq.shape[0]
    if not xq.is_cuda:
        return (xq.double() @ wq.double().T).to(torch.int32)
    Tp = max(32, -(-T // 8) * 8)
    xp = torch.zeros((Tp, xq.shape[1]), dtype=torch.int8, device=xq.device)
    xp[:T] = xq
    return torch._int_mm(xp, wq.T)[:T]


def quantize_head_int4(head: torch.Tensor, model_dtype=torch.bfloat16) -> dict:
    """lm_head table (V, D) -> W4A8 v2 storage, a one-layer stack (per
    group of 128 along D, asymmetric, as the W4A8 projections). Opt-in
    (``embed_quant="int4h"``): int4 rounding leaves ~10% relative logit
    noise at any D, which can flip a close argmax."""
    from kvzip_tpu_torch.ops.w4a8 import quantize_weight_int4
    from kvzip_tpu_torch.ops.w4a8_v2 import repack_scales_v2

    w = repack_scales_v2(quantize_weight_int4(head.T[None]), in_dim=head.shape[1])
    return {**w, "s2": w["s2"].to(model_dtype), "z2": w["z2"].to(model_dtype)}


def head_logits(head, xf: torch.Tensor) -> torch.Tensor:
    """lm_head projection for a plain (V, D) table, an int8 dict or an int4
    dict (:func:`quantize_head_int4`, K8 on the card below 512 rows)."""
    if isinstance(head, dict) and "q4" in head:
        from kvzip_tpu_torch.ops.w4a8 import w4a8_linear_stacked

        return w4a8_linear_stacked(xf, head, 0)
    if isinstance(head, dict):
        xq, xs = quantize_act_int8(xf)
        acc = _int8_rows_dot(xq, head["q"])
        return (acc.float() * xs * head["s"].float()[None]).to(xf.dtype)
    return xf @ head.T
