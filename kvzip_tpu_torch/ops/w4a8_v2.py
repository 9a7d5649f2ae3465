"""K8: the stacked W4A8 linear in the v2 storage.

Port of ``kvzip_tpu/ops/w4a8_v2.py``; the kernel is ``csrc/w4a8.cu``. v2
storage of one weight: bytes ``(L, IN, OUT//2)`` uint8 (the v1 split-packed
bytes, XOR 0x80, trimmed to the true input dim) and bf16 ``s2``/``z2``
``(L, 2, Gp8, OUT//2)`` split by nibble half, the high half pre-folded as
``s_hi / 16`` and ``z_hi + 8 s_hi``, zero-padded to a multiple of 8 groups.

The kernel's plan (:func:`plan`): a unit is one group of 128 input rows
of an output block, ``CB`` byte columns x a block of 8 ``nt`` tokens; an
item is a block over one of ``S`` runs of ``gps`` groups (split-K), items
numbered split-major and blocks column-major, and CTA c of ``grid``
(``occ`` CTAs an SM) takes items c, c + grid, ... (:func:`cta_tiles`), so
that the CTAs at work together read whole weight rows. With S > 1 each
item writes a partial and the last of a block's S adds them in split
order (:func:`merge_order`); with S = 1 an item writes its block. At T <=
``INQ_T`` the CTAs quantize the activations themselves (one launch),
above a first kernel does (two).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, check_kernel_args, on_cuda, sm_count, stream_ptr,
                                 ticket_buffer)
from kvzip_tpu_torch.ops.quant import quantize_act_int8
from kvzip_tpu_torch.ops.w4a8 import GROUP

_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
CB = 128            # byte columns a tile (csrc/w4a8.cu)
INQ_T = 4           # tokens the CTAs quantize themselves, at most
_STAGE_INQ = 17408             # a one-launch stage (csrc/w4a8.cu Cfg::STG)
_SMEM_MAX = 232448 - 1024              # csrc/w4a8.cu SMEM_MAX


@functools.lru_cache(maxsize=None)
def plan(T: int, half: int, G: int, sms: int) -> dict:
    """The launch of K8 over T tokens, ``half`` byte columns and G groups
    of 128 input rows on a card of ``sms`` SMs: ``nt`` (8-token tiles a
    block), ``occ`` (CTAs an SM: 2 where the weight bytes bound the call
    and shared memory allows, four stages each; else 1 with eight),
    ``inq`` (one launch), the blocks (``n_tb`` x ``n_cb``), the split
    (``S`` runs of ``gps`` groups) and ``grid`` (at most ``occ`` x
    ``sms``). S minimises the units of the busiest CTA (waves of items x
    (gps + 1), an item's end costing about a unit) plus, at T > 4, the
    partials the last CTA of a block adds (T KB each, S x T / 32 units).
    Cached: the wrapper asks once a shape, not once a call."""
    nt = 1 if T <= 8 else 2 if T <= 16 else 4 if T <= 32 else 8
    n_tb, n_cb = -(-T // (8 * nt)), -(-half // CB)
    n_out, tokens = n_tb * n_cb, min(T, 8 * nt)

    def split(occ):
        best = None
        for S0 in range(1, G + 1):
            gps = -(-G // S0)
            S = -(-G // gps)
            n_items = n_out * S
            grid = min(occ * sms, n_items)
            cost = -(-n_items // grid) * (gps + 1) + (S * tokens / 32 if T > INQ_T else 0)
            if best is None or cost < best[0]:
                best = (cost, gps, S, grid)
        return best[1:]

    def rows(gps, S, grid):  # the one-launch kernel's quantized groups, their sums, a zero row
        ng = -(-n_out * S // grid) * gps
        return T * (ng * GROUP + 16) + -(-T * ng // 4) * 16 + 16

    inq = T <= INQ_T and 6 * _STAGE_INQ + 1024 + rows(*split(1)) <= _SMEM_MAX
    occ = 2 if nt <= 2 and (not inq or 2 * (4 * _STAGE_INQ + 1024 + rows(*split(2)))
                            <= _SMEM_MAX) else 1
    gps, S, grid = split(occ)
    return dict(nt=nt, occ=occ, inq=inq, n_tb=n_tb, n_cb=n_cb, G=G, gps=gps, S=S, grid=grid)


def cta_tiles(p: dict) -> List[List[Tuple[int, int, int]]]:
    """Each CTA's units in order, as (token block, column block, group)."""
    n_out = p["n_tb"] * p["n_cb"]
    out = []
    for c in range(p["grid"]):
        tiles = []
        for it in range(c, n_out * p["S"], p["grid"]):
            split, o = divmod(it, n_out)
            for g in range(split * p["gps"], min(p["G"], (split + 1) * p["gps"])):
                tiles.append((o % p["n_tb"], o // p["n_tb"], g))
        out.append(tiles)
    return out


def merge_order(p: dict, o: int) -> List[Tuple[int, int]]:
    """The (item, CTA) pairs of output block o (column block o // n_tb,
    token block o % n_tb), one a split, in the order the last of them adds
    their partials (the item is the partial's slot); one pair alone writes
    the block itself."""
    n_out = p["n_tb"] * p["n_cb"]
    return [(s * n_out + o, (s * n_out + o) % p["grid"]) for s in range(p["S"])]


def scratch(p: dict, T: int, IN: int, device: torch.device, owner: str) -> tuple:
    """A launch's scratch (``csrc/w4a8_sm90.cuh::run``) for plan p: the
    items' float32 partials, the blocks' counts (``owner``'s, zero between
    launches) and, at T > ``INQ_T``, the quantized rows, their scales and
    their group sums (None at T <= 4, where the CTAs quantize)."""
    tb = 8 * p["nt"]
    part = torch.empty((p["S"] * p["n_tb"] * p["n_cb"] if p["S"] > 1 else 1, tb, 2 * CB),
                       dtype=torch.float32, device=device)
    tickets = ticket_buffer(owner, device, p["n_tb"] * p["n_cb"])
    quant = (None, None, None)
    if not p["inq"]:
        quant = (torch.empty((T, IN), dtype=torch.int8, device=device),
                 torch.empty((T,), dtype=torch.float32, device=device),
                 torch.empty((IN // GROUP, p["n_tb"] * tb), dtype=torch.int32, device=device))
    return part, tickets, quant


def repack_scales_v2(w: dict, in_dim: int = 0) -> dict:
    """{"q4", "s", "z"} (v1 stacked) -> {"q4", "s2", "z2"}: scales split by
    nibble half ((L, Gp, OUT) -> (L, 2, Gp8, OUT//2)) and pre-folded; with
    ``in_dim`` the byte rows are trimmed to exactly in_dim."""
    L, Gp, OUT = w["s"].shape
    half = OUT // 2

    def split(a):
        return a.reshape(L, Gp, 2, half).transpose(1, 2).to(torch.float32,
                                                            copy=True)

    s2, z2 = split(w["s"]), split(w["z"])
    s2[:, 0] *= 1.0 / 16.0
    z2[:, 0] += 8.0 * s2[:, 0] * 16.0
    q4 = w["q4"]
    if in_dim:
        if in_dim % GROUP:
            raise ValueError(f"in_dim {in_dim} is not a multiple of {GROUP}")
        Gp8 = -(-(in_dim // GROUP) // 8) * 8
        q4 = q4[:, :in_dim]
        s2, z2 = s2[:, :, :Gp8], z2[:, :, :Gp8]
        if Gp8 > Gp:
            pad = s2.new_zeros((L, 2, Gp8 - Gp, half))
            s2, z2 = torch.cat([s2, pad], dim=2), torch.cat([z2, pad], dim=2)
    return {"q4": q4.contiguous(), "s2": s2.to(torch.bfloat16).contiguous(),
            "z2": z2.to(torch.bfloat16).contiguous()}


def repack_w4a8_layers(lp: dict, in_dims: dict) -> dict:
    """Repack every stacked v1 W4A8 dict of a layer tree to v2 (dicts
    already in v2 stay as they are); ``in_dims`` maps weight name -> true
    input dim."""
    out = dict(lp)
    for name, w in lp.items():
        if isinstance(w, dict) and "q4" in w and "s2" not in w:
            out[name] = repack_scales_v2(w, in_dims.get(name, 0))
    return out


def dequantize_weight_int4_v2(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """One layer's v2 slice {"q4": (IN, half), "s2"/"z2": (2, Gp8, half)}
    -> (IN, OUT), un-priming the stored scales in float32."""
    packed = w["q4"]
    IN, half = packed.shape
    G = IN // GROUP
    s2 = w["s2"].float()[:, :G]
    z2 = w["z2"].float()[:, :G]
    s_hi, s_lo = s2[0] * 16.0, s2[1]
    z_hi, z_lo = z2[0] - 8.0 * (s2[0] * 16.0), z2[1]
    b = (packed ^ 0x80).to(torch.int32)
    hi = (b >> 4).float().reshape(G, GROUP, half)
    lo = (b & 0xF).float().reshape(G, GROUP, half)
    cols_hi = hi * s_hi[:, None] + z_hi[:, None]
    cols_lo = lo * s_lo[:, None] + z_lo[:, None]
    return torch.cat([cols_hi, cols_lo], dim=-1).reshape(IN, 2 * half).to(dtype)


def w4a8_jnp_v2(x: torch.Tensor, w: dict, bias=None) -> torch.Tensor:
    """K8's plain version on one layer's v2 slice: the same s8 activation
    rounding, a float32 weight expansion and product."""
    xq, xs = quantize_act_int8(x)
    deq = dequantize_weight_int4_v2(w, torch.float32)
    y = ((xq.float() * xs) @ deq).to(x.dtype)
    return y if bias is None else y + bias


def w4a8_matmul_stacked_v2(x: torch.Tensor, wq4: torch.Tensor,
                           s2: torch.Tensor, z2: torch.Tensor,
                           layer: int) -> torch.Tensor:
    """x (T, IN) times layer ``layer`` of wq4 (L, IN, OUT//2) uint8 with
    s2/z2 (L, 2, Gp8, OUT//2) bf16 -> (T, OUT) in x's dtype."""
    if not on_cuda(x, wq4, s2, z2):
        return w4a8_jnp_v2(x, {"q4": wq4[layer], "s2": s2[layer], "z2": z2[layer]})
    check_kernel_args("w4a8_matmul_stacked_v2", {}, None,
                      dict(x=(x, torch.bfloat16), wq4=(wq4, torch.uint8),
                           s2=(s2, torch.bfloat16), z2=(z2, torch.bfloat16)))
    T, IN = x.shape
    L, IN_w, half = wq4.shape
    Gp8 = s2.shape[2]
    if IN_w != IN or IN % GROUP or half % 16 or s2.shape != (L, 2, Gp8, half) \
            or z2.shape != s2.shape or Gp8 * GROUP < IN or not 0 <= layer < L \
            or x.data_ptr() % 16 or T < 1:
        raise ValueError(f"w4a8_matmul_stacked_v2: bad shapes or alignment x "
                         f"{tuple(x.shape)} q4 {tuple(wq4.shape)} s2 {tuple(s2.shape)} "
                         f"(OUT/2 must be a multiple of 16)")
    dev = x.device
    p = plan(T, half, IN // GROUP, sm_count(dev))
    out = torch.empty((T, 2 * half), dtype=x.dtype, device=dev)
    part, tickets, quant = scratch(p, T, IN, dev, "w4a8_matmul_stacked_v2")
    with torch.cuda.device(dev):
        fn = _build.kernel("w4a8", "kvz_w4a8", _ARGS)
        _build.check(fn(x.data_ptr(), wq4[layer].data_ptr(), s2[layer].data_ptr(),
                        z2[layer].data_ptr(), out.data_ptr(), part.data_ptr(),
                        tickets.data_ptr(), *[None if t is None else t.data_ptr() for t in quant],
                        T, IN, 2 * half, Gp8, p["nt"], p["occ"], int(p["inq"]), p["gps"],
                        p["S"], p["grid"],
                        stream_ptr(dev)), "w4a8_matmul_stacked_v2")
    LAUNCHES["w4a8_matmul_stacked_v2"] += 1
    return out
