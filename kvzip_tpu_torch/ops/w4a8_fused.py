"""K12: the fused W4A8 decode layer, one launch per layer.

Port of ``kvzip_tpu/ops/w4a8_fused.py::w4a8_layer_fused``; the kernel is
``csrc/w4a8_fused.cu``, one cooperative launch whose four products run on
K8's unit (TMA boxes of 128 rows x 128 byte columns on a ring, ``mma.sync``
s8), planned by :func:`plan`: each product's items (a column block over a
split of its groups) taken every grid-th (:func:`cta_units`), a block's
partials added in split order after the next grid barrier (one CTA a row
for the residual, the RMSNorm and the s8 rows; every CTA for SiLU * up and
the qkv rows), the next product's first units asked for before each
barrier (:func:`prefetched`). For T <= 8 token rows it does everything between
two attentions: o-proj of the attention output, ``x1 = rnd(x + rnd(o))``,
RMSNorm with ``ln_mlp[layer]`` and the s8 quantization, gate/up, ``h =
rnd(gate * sigmoid(gate) * up)`` (one rounding, unlike the composed
``F.silu(gate) * up``), the s8 quantization of h by its row maximum, down,
``x2 = rnd(x1 + rnd(dn))``, RMSNorm with the NEXT layer's ``ln_attn``
(clamped to the last layer) and its qkv. Returns ``(x2, qkv)``.

``rnd`` rounds to the model dtype. The arithmetic is the reference
kernel's, not the composed path's: an activation scale is ``amax / 127 +
1e-20`` (the composed ``quantize_act_int8`` adds 1e-8) and the s8 values
are ``round(v * (1 / s))``, unclipped. Weights are the port's v2 stacks
(``ops/w4a8_v2.py``); per group of 128 input rows the reference sums the
s8 activations against the stored bytes read as s8 and against their low
nibbles, with the pre-folded scales.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import LAUNCHES, check_kernel_args, on_cuda, stream_ptr
from kvzip_tpu_torch.ops.attention import _per127
from kvzip_tpu_torch.ops.w4a8 import GROUP

MAX_T = 8          # a decode-shape kernel, as the reference's
GPB = 8            # the reference kernel's groups per reduction step
_CB = 128          # byte columns of one unit of the kernel (csrc/w4a8_fused.cu)
_MAX_SPLITS = 16   # splits of a product's input groups
_NS = 4            # the kernel's ring stages
_XB_MAX = 40960    # shared memory for a CTA's quantized groups of one product
_NAMES = ("w_o", "w_gu", "w_dn", "w_qkv")

_ARGS = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 16 + [ctypes.c_float, ctypes.c_void_p]
_GRIDS: Dict[int, int] = {}
_MAPS: Dict[tuple, ctypes.Array] = {}


def _ones_over(s: torch.Tensor) -> torch.Tensor:
    """1 / s with IEEE division (a tensor divided by a tensor)."""
    return torch.div(torch.ones_like(s), s)


def _quant(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row s8 values (as float32) and scales of float32 rows v."""
    s = _per127(v.abs().amax(dim=-1, keepdim=True))
    return torch.round(v * _ones_over(s)), s


def _product(xq: torch.Tensor, w: dict, layer: int) -> torch.Tensor:
    """s8 rows xq (T, IN) times layer ``layer`` of a v2 stack, before the
    token scale -> (T, OUT) float32, summed as the reference kernel sums:
    per step of GPB groups the activation sums times the zeros, then each
    group's exact integer products times its scales."""
    q4 = w["q4"][layer]
    s2, z2 = w["s2"][layer].float(), w["z2"][layer].float()
    IN, half = q4.shape
    G = IN // GROUP
    T = xq.shape[0]
    xg = xq.reshape(T, G, GROUP).transpose(0, 1)                     # (G, T, 128)
    sb = torch.bmm(xg, q4.view(torch.int8).float().reshape(G, GROUP, half))
    lo = torch.bmm(xg, (q4 & 0xF).float().reshape(G, GROUP, half))  # exact: < 2^24
    d_hi = sb - lo
    xsums = xg.sum(dim=-1).T                                          # (T, G)
    acc_hi = acc_lo = None
    for b0 in range(0, G, GPB):
        b1 = min(b0 + GPB, G)
        hi = xsums[:, b0:b1] @ z2[0, b0:b1]
        low = xsums[:, b0:b1] @ z2[1, b0:b1]
        for g in range(b0, b1):
            hi = hi + d_hi[g] * s2[0, g]
            low = low + lo[g] * s2[1, g]
        acc_hi = hi if acc_hi is None else acc_hi + hi
        acc_lo = low if acc_lo is None else acc_lo + low
    return torch.cat([acc_hi, acc_lo], dim=1)


def w4a8_layer_fused_plain(x, attn_out, ln_mlp, ln_attn, w_o, w_gu, w_dn, w_qkv, layer,
                           *, eps, qkv_layer=None):
    dtype = x.dtype
    L = ln_mlp.shape[0]

    def rnd(v):
        return v.to(dtype).float()

    def norm_quant(xr, w):
        var = (xr * xr).mean(dim=-1, keepdim=True)
        return _quant(rnd(xr * torch.rsqrt(var + eps) * w.float()))

    aq, s = _quant(attn_out.float())
    x1 = rnd(x.float() + rnd(_product(aq, w_o, layer) * s))
    hq, s = norm_quant(x1, ln_mlp[layer])
    gu = _product(hq, w_gu, layer) * s
    I = gu.shape[1] // 2
    gate, up = rnd(gu[:, :I]), rnd(gu[:, I:])
    hq, s = _quant(rnd(gate * torch.sigmoid(gate) * up))
    x2 = rnd(x1 + rnd(_product(hq, w_dn, layer) * s))
    hq, s = norm_quant(x2, ln_attn[min(layer + 1, L - 1)])
    qkv = _product(hq, w_qkv, layer if qkv_layer is None else qkv_layer) * s
    return x2.to(dtype), qkv.to(dtype)


def _splits(G: int, half: int, T: int, grid: int) -> int:
    """Splits of a product's G input groups: the fewest units of the
    busiest CTA (waves of items x (groups an item + 1), an item's partial
    costing about a unit), with at most 16 splits and partial sums of at
    most an eighth of the weight bytes (S <= 2 G / T); no split left empty.
    (Planning for the busiest SM instead, with half the CTAs at work on
    down, was slower: a CTA's four stages in flight do not carry an SM's
    share of the bandwidth.)"""
    ncb = -(-half // _CB)
    best = None
    for S0 in range(1, min(G, _MAX_SPLITS, max(1, 2 * G // T)) + 1):
        gps = -(-G // S0)
        S = -(-G // gps)
        cost = -(-ncb * S // grid) * (gps + 1)
        if best is None or cost < best[0]:
            best = (cost, S)
    return best[1]


@functools.lru_cache(maxsize=None)
def plan(T: int, dims: Tuple[Tuple[int, int], ...], grid: int) -> dict:
    """The launch of K12 over T token rows on ``grid`` CTAs, ``dims`` the
    (IN, OUT//2) of o-proj, gate/up, down and qkv: each product's column
    blocks (``ncb``), groups (``G``), splits (``S``, each a run of ``gps``
    groups) and items (``ncb * S``, split-major); ``xbuf``, the most bytes
    a CTA's quantized groups of one product take (they must fit the
    kernel's ``_XB_MAX``). Cached: the wrapper asks once a shape."""
    prods, xbuf = [], 0
    for IN, half in dims:
        G = IN // GROUP
        S = _splits(G, half, T, grid)
        gps, ncb = -(-G // S), -(-half // _CB)
        ng = -(-ncb * S // grid) * gps  # the busiest CTA's group slots
        xbuf = max(xbuf, T * (ng * GROUP + 16) + -(-T * ng // 4) * 16)
        prods.append(dict(IN=IN, half=half, G=G, S=S, gps=gps, ncb=ncb, n_items=ncb * S))
    return dict(T=T, grid=grid, products=prods, xbuf=xbuf)


def cta_units(p: dict, c: int) -> List[Tuple[int, int, int, int]]:
    """CTA c's stream of units over the four products, in the order its
    thread 0 loads them: (product, column block, group, split), items c,
    c + grid, ... of each product and each item's groups in order."""
    out = []
    for k, pr in enumerate(p["products"]):
        for it in range(c, pr["n_items"], p["grid"]):
            split, cb = divmod(it, pr["ncb"])
            for g in range(split * pr["gps"], min(pr["G"], (split + 1) * pr["gps"])):
                out.append((k, cb, g, split))
    return out


def prefetched(p: dict, c: int, k: int) -> List[Tuple[int, int, int, int]]:
    """The units of product k that CTA c has asked for when it reaches the
    barrier before product k: its first ``_NS`` (the ring's stages), asked
    for once its units of product k - 1 are done (none while they are in
    flight, so a product's units are not read behind the next one's)."""
    return [u for u in cta_units(p, c) if u[0] == k][:_NS]


def _grid(device: torch.device) -> int:
    """The cooperative grid on ``device``: every CTA resident with the
    kernel's dynamic shared memory (two an SM on the H100)."""
    key = device.index
    if key not in _GRIDS:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            fn = _build.kernel("w4a8_fused", "kvz_w4a8_fused_grid", [ctypes.c_void_p])
            _build.check(fn(ctypes.addressof(blocks)), "w4a8_layer_fused grid")
        if blocks.value < 1:
            raise RuntimeError("w4a8_layer_fused: no CTA of the kernel fits on the device")
        _GRIDS[key] = blocks.value
    return _GRIDS[key]


def _tensor_map(q4: torch.Tensor) -> ctypes.Array:
    """The kernel's tensor map of a (L, IN, OUT//2) byte stack, encoded once
    a stack (a map holds only the address and the shape, so an entry stays
    right for whatever tensor lies there later)."""
    L, IN, half = q4.shape
    key = (q4.device.index, q4.data_ptr(), L, IN, half)
    m = _MAPS.get(key)
    if m is None:
        m = ctypes.create_string_buffer(128)
        with torch.cuda.device(q4.device):
            fn = _build.kernel("w4a8_fused", "kvz_w4a8_fused_map",
                               [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            _build.check(fn(q4.data_ptr(), L, IN, half, m), "w4a8_layer_fused tensor map")
        _MAPS[key] = m
    return m


def w4a8_layer_fused(x: torch.Tensor, attn_out: torch.Tensor, ln_mlp: torch.Tensor,
                     ln_attn: torch.Tensor, w_o: dict, w_gu: dict, w_dn: dict, w_qkv: dict,
                     layer: int, *, eps: float,
                     qkv_layer: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) and attn_out (T, H*Dh) with T <= 8; ln_mlp / ln_attn (L, D);
    w_o, w_gu (gate in the high nibbles, up in the low ones), w_dn and
    w_qkv v2 stacks {"q4": (L, IN, OUT//2) uint8, "s2"/"z2": (L, 2, Gp8,
    OUT//2)} -> (x_new (T, D), qkv (T, QKV)) in x's dtype.

    The qkv product reads w_qkv at ``layer``, as the reference kernel does,
    unless ``qkv_layer`` names another: the forward passes the next layer,
    whose q, k and v the product makes (the reference's forward passes
    ``layer``, so from its second layer on it attends with the previous
    layer's qkv weights)."""
    T, D = x.shape
    if not 1 <= T <= MAX_T or attn_out.shape[0] != T:
        raise ValueError(f"w4a8_layer_fused: T {T} (attn {tuple(attn_out.shape)}) "
                         f"must be 1..{MAX_T}")
    weights = (w_o, w_gu, w_dn, w_qkv)
    stacks = [w[k] for w in weights for k in ("q4", "s2", "z2")]
    if not on_cuda(x, attn_out, ln_mlp, ln_attn, *stacks):
        return w4a8_layer_fused_plain(x, attn_out, ln_mlp, ln_attn, *weights, layer, eps=eps,
                                      qkv_layer=qkv_layer)
    bf = (torch.bfloat16,)
    other = dict(x=(x, *bf), attn_out=(attn_out, *bf), ln_mlp=(ln_mlp, *bf),
                 ln_attn=(ln_attn, *bf))
    for name, w in zip(_NAMES, weights):
        other.update({f"{name}.q4": (w["q4"], torch.uint8), f"{name}.s2": (w["s2"], *bf),
                      f"{name}.z2": (w["z2"], *bf)})
    check_kernel_args("w4a8_layer_fused", {}, None, other)
    L = ln_mlp.shape[0]
    HD, I = attn_out.shape[1], w_gu["q4"].shape[2]
    dims = {"w_o": (HD, D // 2), "w_gu": (D, I), "w_dn": (I, D // 2),
            "w_qkv": (D, w_qkv["q4"].shape[2])}
    for name, w in zip(_NAMES, weights):
        IN, half = dims[name]
        Gp8 = w["s2"].shape[2]
        if w["q4"].shape != (L, IN, half) or w["s2"].shape != (L, 2, Gp8, half) \
                or w["z2"].shape != w["s2"].shape or IN % GROUP or half % 16 \
                or Gp8 * GROUP < IN:
            raise ValueError(f"w4a8_layer_fused: {name} q4 {tuple(w['q4'].shape)} s2 "
                             f"{tuple(w['s2'].shape)} does not fit x {tuple(x.shape)} "
                             f"attn {tuple(attn_out.shape)} (OUT/2 a multiple of 16)")
    ql = layer if qkv_layer is None else qkv_layer
    if D % 2 or ln_mlp.shape != (L, D) or ln_attn.shape != (L, D) or not 0 <= layer < L \
            or not 0 <= ql < L:
        raise ValueError(f"w4a8_layer_fused: ln {tuple(ln_mlp.shape)} / "
                         f"{tuple(ln_attn.shape)}, x {tuple(x.shape)}, layer {layer}")
    dev = x.device
    p = plan(T, tuple(dims[n] for n in _NAMES), _grid(dev))
    if p["xbuf"] > _XB_MAX:
        raise ValueError(f"w4a8_layer_fused: a CTA's quantized groups take {p['xbuf']} bytes "
                         f"of shared memory, more than {_XB_MAX}")
    S = [pr["S"] for pr in p["products"]]
    part = max(pr["S"] * T * 2 * pr["half"] for pr in p["products"])
    f32 = dict(dtype=torch.float32, device=dev)
    x_new = torch.empty_like(x)
    qkv = torch.empty((T, 2 * dims["w_qkv"][1]), dtype=x.dtype, device=dev)
    xq = torch.empty((T, D), dtype=torch.int8, device=dev)
    xs = torch.empty((T,), **f32)
    hmax = torch.empty((T,), dtype=torch.int32, device=dev)
    xrow = torch.empty((T, D), **f32)
    hbuf = torch.empty((T, I), **f32)
    partial = torch.empty((part,), **f32)
    ptrs = [t.data_ptr() for t in (x, attn_out, ln_mlp[layer], ln_attn[min(layer + 1, L - 1)])]
    with torch.cuda.device(dev):
        ptrs += [ctypes.addressof(_tensor_map(w["q4"])) for w in weights]
        for w, wl in zip(weights, (layer, layer, layer, ql)):
            ptrs += [w["s2"][wl].data_ptr(), w["z2"][wl].data_ptr()]
        ptrs += [t.data_ptr() for t in (x_new, qkv, xq, xs, hmax, xrow, hbuf, partial)]
        fn = _build.kernel("w4a8_fused", "kvz_w4a8_layer_fused", _ARGS)
        _build.check(fn(*ptrs, T, D, HD, I, dims["w_qkv"][1],
                        *[w["s2"].shape[2] for w in weights], *S, layer, ql, p["grid"], eps,
                        stream_ptr(dev)), "w4a8_layer_fused")
    LAUNCHES["w4a8_layer_fused"] += 1
    return x_new, qkv
