"""K4: decode attention (T <= 8) against the dense cache.

Port of ``kvzip_tpu/ops/ragged_decode.py::ragged_decode_attend``; the kernel
is ``csrc/ragged_decode.cu`` (flash-decoding: per-split partials, then a
merge).
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args,
                                 on_cuda, stream_ptr)

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p]
MAX_T = 8


def split_size(n_keys: int, groups: int, target: int = 1024) -> int:
    """Keys per flash-decoding split: the smallest power-of-two multiple of
    the 64-key tile that keeps the grid near ``target`` CTAs."""
    ch = 64
    while groups * -(-n_keys // ch) > target and ch < 1 << 16:
        ch *= 2
    return ch


def ragged_decode_attend_plain(q, k_cache, v_cache, base_lens, *, scale):
    return attention.attend_dense(q, k_cache, v_cache, base_lens, scale=scale)


def ragged_decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, base_lens: torch.Tensor, *,
                         scale: float) -> torch.Tensor:
    """q (T <= 8, H, D); k/v (Hkv, C, D); base_lens (Hkv,) int32, the live
    rows before this block's T appended rows -> (T, H, D)."""
    if not on_cuda(q, k_cache, v_cache, base_lens):
        return ragged_decode_attend_plain(q, k_cache, v_cache, base_lens,
                                          scale=scale)
    check_kernel_args("ragged_decode_attend",
                      dict(q=q, k_cache=k_cache, v_cache=v_cache),
                      dict(base_lens=base_lens))
    T, H, D = q.shape
    Hkv, C, _ = k_cache.shape
    if T > MAX_T or H % Hkv or v_cache.shape != k_cache.shape \
            or base_lens.shape != (Hkv,):
        raise ValueError(f"ragged_decode_attend: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)}")
    R = (H // Hkv) * T
    ch = split_size(C, Hkv * -(-R // 64))
    S = -(-C // ch)
    out = torch.empty_like(q)
    part_acc = torch.empty((Hkv, S, R, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((Hkv, S, R, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        fn = _build.kernel("ragged_decode", "kvz_ragged_decode", _ARGS)
        _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        base_lens.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                        part_ml.data_ptr(), T, H, Hkv, C, ch, scale,
                        stream_ptr(q.device)), "ragged_decode_attend")
    LAUNCHES["ragged_decode_attend"] += 1
    return out
