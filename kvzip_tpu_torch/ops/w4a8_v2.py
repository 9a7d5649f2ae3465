"""K8: the stacked W4A8 linear in the v2 storage.

Port of ``kvzip_tpu/ops/w4a8_v2.py``; the kernel is ``csrc/w4a8.cu``. v2
storage of one weight: bytes ``(L, IN, OUT//2)`` uint8 (the v1 split-packed
bytes, XOR 0x80, trimmed to the true input dim) and bf16 ``s2``/``z2``
``(L, 2, Gp8, OUT//2)`` split by nibble half, the high half pre-folded as
``s_hi / 16`` and ``z_hi + 8 s_hi``, zero-padded to a multiple of 8 groups.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import LAUNCHES, check_kernel_args, on_cuda, stream_ptr
from kvzip_tpu_torch.ops.quant import quantize_act_int8
from kvzip_tpu_torch.ops.w4a8 import GROUP, split_groups

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    if IN_w != IN or IN % GROUP or half % 4 or s2.shape != (L, 2, Gp8, half) \
            or z2.shape != s2.shape or Gp8 * GROUP < IN or not 0 <= layer < L \
            or x.data_ptr() % 16:
        raise ValueError(f"w4a8_matmul_stacked_v2: bad shapes or alignment x "
                         f"{tuple(x.shape)} q4 {tuple(wq4.shape)} s2 {tuple(s2.shape)}")
    tt, gps, S = split_groups(T, half, IN // GROUP)
    dev = x.device
    out = torch.empty((T, 2 * half), dtype=x.dtype, device=dev)
    xq = torch.empty((T, IN), dtype=torch.int8, device=dev)
    xs = torch.empty((T,), dtype=torch.float32, device=dev)
    part = torch.empty((S, T, 2 * half), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fn = _build.kernel("w4a8", "kvz_w4a8", _ARGS)
        _build.check(fn(x.data_ptr(), wq4[layer].data_ptr(), s2[layer].data_ptr(),
                        z2[layer].data_ptr(), out.data_ptr(), xq.data_ptr(),
                        xs.data_ptr(), part.data_ptr(), T, IN, 2 * half, Gp8, gps,
                        tt, stream_ptr(dev)), "w4a8_matmul_stacked_v2")
    LAUNCHES["w4a8_matmul_stacked_v2"] += 1
    return out
