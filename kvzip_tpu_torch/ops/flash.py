"""K1: causal GQA flash attention over the dense cache (prefill, scoring).

Port of ``kvzip_tpu/ops/flash.py::flash_attend``; the kernel is
``csrc/flash.cu`` (TMA loads and wgmma, one CTA per query head and block
of 128 queries). Key j of kv head h is visible to query i iff
``j < base_lens[h] + i + 1``.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args,
                                 check_tma_aligned, on_cuda, stream_ptr)

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                      ctypes.c_void_p]


def flash_attend_plain(q, k_cache, v_cache, base_lens, *, scale):
    return attention.attend_blockwise(q, k_cache, v_cache, base_lens,
                                      scale=scale)


def flash_attend(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, base_lens: torch.Tensor, *,
                 scale: float) -> torch.Tensor:
    """q (T, H, D); k/v (Hkv, C, D); base_lens (Hkv,) int32 -> (T, H, D)."""
    if not on_cuda(q, k_cache, v_cache, base_lens):
        return flash_attend_plain(q, k_cache, v_cache, base_lens, scale=scale)
    check_kernel_args("flash_attend", dict(q=q, k_cache=k_cache, v_cache=v_cache),
                      dict(base_lens=base_lens))
    T, H, D = q.shape
    Hkv, C, _ = k_cache.shape
    if H % Hkv or v_cache.shape != k_cache.shape or base_lens.shape != (Hkv,):
        raise ValueError(f"flash_attend: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} lens {tuple(base_lens.shape)}")
    check_tma_aligned("flash_attend", q=q, k_cache=k_cache, v_cache=v_cache)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = _build.kernel("flash", "kvz_flash_attend", _ARGS)
        _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        base_lens.data_ptr(), out.data_ptr(), T, H, Hkv, C,
                        scale, stream_ptr(q.device)), "flash_attend")
    LAUNCHES["flash_attend"] += 1
    return out
