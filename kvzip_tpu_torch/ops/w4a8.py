"""W4A8 linears: int4 weights (per-group-128 asymmetric) times per-token
int8 activations.

Port of ``kvzip_tpu/ops/w4a8.py``: quantizing a weight (stack) into the v1
layout and its expansion, fusing q/k/v and gate/up, the v1 linears K15
(``w4a8_matmul_stacked``) and K16 (``w4a8_matmul``), whose kernel is
``csrc/w4a8_v1.cu``, and the stacked-linear dispatch.

v1 layout: packed ``(..., INp, OUT//2)`` uint8, split packing along OUT
(byte column j holds weight column j in the high nibble and j + OUT/2 in
the low one) and stored XOR 0x80; bf16 scale/zero ``(..., Gp, OUT)`` per
(input group, output column), with pad groups of scale = zero = 0. K15 and
K16 share K8's kernel body (``csrc/w4a8_sm90.cuh``) and its plan
(``ops/w4a8_v2.py::plan``); they read the true groups only.
``prepare_params`` repacks a ``weight_quant="w4a8"`` tree to v2
(``ops/w4a8_v2.py``, K8); a v1 tree passed with ``weight_quant="none"``
(what ``load_hf_params(..., weight_quant="w4a8")`` gives) runs as it is.

Dispatch (``w4a8_linear_stacked``, on ``"s2" in w`` as the reference's):
on the card, T >= ``DEQUANT_T`` rows dequantize the layer to bf16 and take
one ``torch.mm`` (the reference also leaves this product to its compiler),
smaller T launch K8 (v2) or K15 (v1). On the CPU every T takes the plain
version of the layer slice, as the reference does on its CPU backend.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import LAUNCHES, check_kernel_args, on_cuda, sm_count, stream_ptr
from kvzip_tpu_torch.ops.quant import quantize_act_int8

GROUP = 128
MAX_GPB = 16          # the reference kernel's groups per grid step
DEQUANT_T = 512
_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


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


def _w4a8_jnp(x: torch.Tensor, w: dict, bias=None) -> torch.Tensor:
    """K15/K16's plain version on one v1 weight {"q4": (INp, OUT//2), "s"/
    "z": (Gp, OUT)}: the same s8 activation rounding (zero-padded to INp),
    a float32 weight expansion and product."""
    xq, xs = quantize_act_int8(x)
    INp = w["q4"].shape[0]
    if INp != x.shape[-1]:
        xq = torch.nn.functional.pad(xq, (0, INp - x.shape[-1]))
    y = ((xq.float() * xs) @ dequantize_weight_int4(w, torch.float32)).to(x.dtype)
    return y if bias is None else y + bias


def _launch_v1(what: str, x: torch.Tensor, wq4: torch.Tensor, ws: torch.Tensor,
               wz: torch.Tensor, layer: int, bias) -> torch.Tensor:
    """One call of ``csrc/w4a8_v1.cu`` (K8's body with the v1 scales) on
    layer ``layer`` of (L, INp, OUT//2) bytes and (L, Gp, OUT) scales,
    planned as K8 is (``ops/w4a8_v2.py::plan``, the true groups only)."""
    from kvzip_tpu_torch.ops.w4a8_v2 import plan, scratch

    other = dict(x=(x, torch.bfloat16), wq4=(wq4, torch.uint8),
                 ws=(ws, torch.bfloat16), wz=(wz, torch.bfloat16))
    if bias is not None:
        other["bias"] = (bias, torch.bfloat16)
    check_kernel_args(what, {}, None, other)
    T, IN = x.shape
    L, INp, half = wq4.shape
    Gp, OUT = ws.shape[1:]
    if OUT != 2 * half or half % 16 or IN % GROUP or IN > INp or INp != Gp * GROUP \
            or ws.shape != (L, Gp, OUT) or wz.shape != ws.shape or not 0 <= layer < L \
            or T < 1 or x.data_ptr() % 16 or (bias is not None and bias.shape != (OUT,)):
        raise ValueError(f"{what}: bad shapes or alignment x {tuple(x.shape)} q4 "
                         f"{tuple(wq4.shape)} s {tuple(ws.shape)} layer {layer} "
                         f"(OUT/2 must be a multiple of 16)")
    dev = x.device
    p = plan(T, half, IN // GROUP, sm_count(dev))
    out = torch.empty((T, OUT), dtype=x.dtype, device=dev)
    part, tickets, quant = scratch(p, T, IN, dev, what)
    with torch.cuda.device(dev):
        fn = _build.kernel("w4a8_v1", "kvz_w4a8_v1", _ARGS)
        _build.check(fn(x.data_ptr(), wq4[layer].data_ptr(), ws[layer].data_ptr(),
                        wz[layer].data_ptr(), None if bias is None else bias.data_ptr(),
                        out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                        *[None if t is None else t.data_ptr() for t in quant],
                        T, IN, OUT, p["nt"], p["occ"], int(p["inq"]), p["gps"], p["S"],
                        p["grid"], stream_ptr(dev)), what)
    LAUNCHES[what] += 1
    return out


def w4a8_matmul(x: torch.Tensor, wq4: torch.Tensor, ws: torch.Tensor, wz: torch.Tensor,
                bias=None) -> torch.Tensor:
    """K16: x (T, IN) times one v1 weight, wq4 (INp, OUT//2) uint8 and ws/wz
    (Gp, OUT) bf16, plus ``bias`` (OUT,) added after the cast -> (T, OUT)
    in x's dtype."""
    tensors = [x, wq4, ws, wz] + ([] if bias is None else [bias])
    if not on_cuda(*tensors):
        return _w4a8_jnp(x, {"q4": wq4, "s": ws, "z": wz}, bias)
    return _launch_v1("w4a8_matmul", x, wq4[None], ws[None], wz[None], 0, bias)


def w4a8_matmul_stacked(x: torch.Tensor, wq4: torch.Tensor, ws: torch.Tensor,
                        wz: torch.Tensor, layer: int) -> torch.Tensor:
    """K15: x (T, IN) times layer ``layer`` of v1 stacks, wq4 (L, INp,
    OUT//2) uint8 and ws/wz (L, Gp, OUT) bf16 -> (T, OUT) in x's dtype.
    The kernel reads the layer in place."""
    if not on_cuda(x, wq4, ws, wz):
        return _w4a8_jnp(x, {"q4": wq4[layer], "s": ws[layer], "z": wz[layer]})
    return _launch_v1("w4a8_matmul_stacked", x, wq4, ws, wz, layer, None)


def w4a8_linear(x: torch.Tensor, w: dict, bias=None) -> torch.Tensor:
    """Linear over one v1 weight dict {"q4", "s", "z"} (K16 on the card)."""
    return w4a8_matmul(x, w["q4"], w["s"], w["z"], bias)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands accumulated and returned in float32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _w4a8_dequant_matmul(x: torch.Tensor, w: dict, layer: int,
                         bias=None) -> torch.Tensor:
    """Prefill-shape route: dequantize one layer (v2 to (IN, OUT), v1 to
    (INp, OUT) with zero pad rows) to bf16 and take one product of the s8
    activations (exact in bf16, zero-padded to the weight's rows) with it,
    accumulated in float32; the bf16 expansion adds ~2^-9 rounding on top
    of the int4 grid."""
    from kvzip_tpu_torch.ops.w4a8_v2 import dequantize_weight_int4_v2

    wl = {k: v[layer] for k, v in w.items()}
    if "s2" in wl:
        deq = dequantize_weight_int4_v2(wl, torch.bfloat16)
    else:
        deq = dequantize_weight_int4(wl, torch.bfloat16)
    xq, xs = quantize_act_int8(x)
    if deq.shape[0] != x.shape[-1]:
        xq = torch.nn.functional.pad(xq, (0, deq.shape[0] - x.shape[-1]))
    y = (_mm_f32(xq.to(torch.bfloat16), deq) * xs).to(x.dtype)
    return y if bias is None else y + bias


def w4a8_linear_stacked(x: torch.Tensor, w: dict, layer: int,
                        bias=None) -> torch.Tensor:
    """x (T, IN) times layer ``layer`` of a W4A8 stack -> (T, OUT): v2
    {"q4": (L, IN, OUT//2), "s2"/"z2": (L, 2, Gp8, OUT//2)} or v1 {"q4":
    (L, INp, OUT//2), "s"/"z": (L, Gp, OUT)}."""
    from kvzip_tpu_torch.ops.w4a8_v2 import w4a8_matmul_stacked_v2

    if x.is_cuda and x.shape[0] >= DEQUANT_T:
        return _w4a8_dequant_matmul(x, w, layer, bias)
    if "s2" in w:
        y = w4a8_matmul_stacked_v2(x, w["q4"], w["s2"], w["z2"], layer)
    else:
        y = w4a8_matmul_stacked(x, w["q4"], w["s"], w["z"], layer)
    return y if bias is None else y + bias
