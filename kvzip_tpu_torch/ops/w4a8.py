"""W4A8 linears: int4 weights (per-group-128 asymmetric) times per-token
int8 activations.

Port of the parts of ``kvzip_tpu/ops/w4a8.py`` that the v2 storage path
needs: quantizing a weight stack (v1 layout) and its expansion, fusing
q/k/v and gate/up, and the stacked-linear dispatch.

v1 layout: packed ``(..., INp, OUT//2)`` uint8, split packing along OUT
(byte column j holds weight column j in the high nibble and j + OUT/2 in
the low one) and stored XOR 0x80; bf16 scale/zero ``(..., Gp, OUT)`` per
(input group, output column), with pad groups of scale = zero = 0.
``prepare_params`` repacks it to v2 (``ops/w4a8_v2.py``), which the
forward runs.

Dispatch (``w4a8_linear_stacked``): on the card, T >= ``DEQUANT_T`` rows
dequantize the layer to bf16 and take one ``torch.mm`` (the reference
also leaves this product to its compiler), smaller T launch K8
(``w4a8_v2.w4a8_matmul_stacked_v2``). On the CPU every T takes K8's plain
version, as the reference does on its CPU backend.
"""

from __future__ import annotations

import torch

from kvzip_tpu_torch.ops.quant import quantize_act_int8

GROUP = 128
MAX_GPB = 16          # the reference kernel's groups per grid step
DEQUANT_T = 512


def _pad_groups(n_groups: int) -> int:
    gpb = min(MAX_GPB, n_groups)
    return -(-n_groups // gpb) * gpb


def quantize_weight_int4(w: torch.Tensor, group: int = GROUP) -> dict:
    """w (..., IN, OUT) -> {"q4": (..., INp, OUT//2) uint8, "s"/"z":
    (..., Gp, OUT) bf16}. The scale and zero are rounded to bf16 before
    the nibbles are chosen, so the stored grid is exactly consistent."""
    *lead, IN, OUT = w.shape
    if IN % group or OUT % 2:
        raise ValueError(f"quantize_weight_int4: shape {tuple(w.shape)}")
    G = IN // group
    Gp = _pad_groups(G)
    wf = w.float().reshape(*lead, G, group, OUT)
    mn = wf.amin(dim=-2)
    mx = wf.amax(dim=-2)
    s = ((mx - mn) / 15.0 + 1e-8).to(torch.bfloat16).float()
    z = mn.to(torch.bfloat16).float()
    q = torch.clamp(torch.round((wf - z[..., None, :]) / s[..., None, :]), 0, 15)
    q = q.to(torch.uint8).reshape(*lead, IN, OUT)
    half = OUT // 2
    packed = ((q[..., :half] << 4) | q[..., half:]) ^ 0x80
    if Gp != G:
        pad = Gp - G
        packed = torch.cat([packed, packed.new_zeros((*lead, pad * group, half))],
                           dim=-2)
        s = torch.cat([s, s.new_zeros((*lead, pad, OUT))], dim=-2)
        z = torch.cat([z, z.new_zeros((*lead, pad, OUT))], dim=-2)
    return {"q4": packed, "s": s.to(torch.bfloat16), "z": z.to(torch.bfloat16)}


def dequantize_weight_int4(wq: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """v1 storage -> (..., INp, OUT) weights; pad rows come out zero (their
    scale and zero are 0)."""
    q = _unpack_nibbles(wq["q4"]).float()                 # (..., INp, OUT)
    *lead, INp, OUT = q.shape
    Gp = wq["s"].shape[-2]
    qg = q.reshape(*lead, Gp, INp // Gp, OUT)
    x = qg * wq["s"].float()[..., None, :] + wq["z"].float()[..., None, :]
    return x.reshape(*lead, INp, OUT).to(dtype)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Stored split-packed bytes -> logical uint4 columns (..., OUT)."""
    b = packed ^ 0x80
    return torch.cat([b >> 4, b & 0xF], dim=-1)


def fuse_w4a8(ws: list) -> dict:
    """Concatenate int4 weight dicts along OUT (lossless: scales are per
    output column), repacked so the fused bytes are canonical split
    packing and the output is ``[w0 | w1 | ...]``."""
    q = torch.cat([_unpack_nibbles(w["q4"]) for w in ws], dim=-1)
    half = q.shape[-1] // 2
    return {"q4": ((q[..., :half] << 4) | q[..., half:]) ^ 0x80,
            "s": torch.cat([w["s"] for w in ws], dim=-1),
            "z": torch.cat([w["z"] for w in ws], dim=-1)}


def fuse_w4a8_params(layers: dict) -> dict:
    """wq/wk/wv -> wqkv and w_gate/w_up -> w_gateup in a stacked W4A8
    layer dict (one launch and one activation quant each), one layer at a
    time so the unpacked transient stays one layer's size."""
    lp = dict(layers)
    for fused, names in (("wqkv", ("wq", "wk", "wv")),
                         ("w_gateup", ("w_gate", "w_up"))):
        if not all(isinstance(lp.get(n), dict) and "q4" in lp[n] for n in names):
            continue
        L = lp[names[0]]["q4"].shape[0]
        parts = [fuse_w4a8([{k: v[l] for k, v in lp[n].items()} for n in names])
                 for l in range(L)]
        lp[fused] = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        for n in names:
            del lp[n]
    return lp


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands accumulated and returned in float32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _w4a8_dequant_matmul(x: torch.Tensor, w: dict, layer: int,
                         bias=None) -> torch.Tensor:
    """Prefill-shape route: dequantize one layer to bf16 and take one
    product of the s8 activations (exact in bf16) with it, accumulated in
    float32; the bf16 expansion adds ~2^-9 rounding on top of the int4
    grid."""
    from kvzip_tpu_torch.ops.w4a8_v2 import dequantize_weight_int4_v2

    deq = dequantize_weight_int4_v2({k: v[layer] for k, v in w.items()},
                                    torch.bfloat16)
    xq, xs = quantize_act_int8(x)
    y = (_mm_f32(xq.to(torch.bfloat16), deq) * xs).to(x.dtype)
    return y if bias is None else y + bias


def w4a8_linear_stacked(x: torch.Tensor, w: dict, layer: int,
                        bias=None) -> torch.Tensor:
    """x (T, IN) times layer ``layer`` of a v2 W4A8 stack {"q4": (L, IN,
    OUT//2), "s2"/"z2": (L, 2, Gp8, OUT//2)} -> (T, OUT)."""
    from kvzip_tpu_torch.ops.w4a8_v2 import w4a8_matmul_stacked_v2

    if x.is_cuda and x.shape[0] >= DEQUANT_T:
        return _w4a8_dequant_matmul(x, w, layer, bias)
    y = w4a8_matmul_stacked_v2(x, w["q4"], w["s2"], w["z2"], layer)
    return y if bias is None else y + bias
