"""K5 and K6: causal GQA flash attention over the dense int4 cache.

Port of ``kvzip_tpu/ops/flash_int4.py``; the kernels are
``csrc/flash_int4.cu``. The cache holds split-packed rows ``(Hkv, C, D//2)``
uint8 with one (scale, zero) per row ``(Hkv, C)`` (``cache.Int4KVCache``).

- K5 ``flash_attend_int4``: the T new rows were appended at ``base_lens``;
  key j of head h is visible to query i iff ``j < base_lens[h] + i + 1``.
  T <= ``SPLIT_T`` (decode) runs K4's one-launch body with an int4 row
  source (``csrc/split_decode.cuh``; its grid planned by
  ``ragged_decode.plan_splits``; also counted in
  ``LAUNCHES["flash_attend_int4_decode"]``); T > ``SPLIT_T`` the TMA and
  wgmma body that K6 shares.
- K6 ``flash_attend_int4_extra``: the read-only scoring forward. Nothing is
  appended: cache rows ``[0, base_lens[h])`` are visible to every query and
  the chunk's own quantized rows ``(T, Hkv, D//2)`` are causal within the
  chunk, as if they had been appended at ``base_lens``.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, HEAD_DIM, attention,
                                 check_kernel_args, check_tma_aligned, on_cuda,
                                 sm_count, stream_ptr)
from kvzip_tpu_torch.ops.ragged_decode import plan_splits, split_scratch

SPLIT_T = 16  # T at or below which K5 runs as flash-decoding

_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                      ctypes.c_void_p]
_ARGS_DECODE = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                              ctypes.c_void_p]
_ARGS_EXTRA = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                             ctypes.c_void_p]


def flash_attend_int4_plain(q, k_q, k_s, k_z, v_q, v_s, v_z, base_lens, *,
                            scale):
    return attention.attend_blockwise_int4(q, k_q, k_s, k_z, v_q, v_s, v_z,
                                           base_lens, scale=scale)


def flash_attend_int4_extra_plain(q, k_q, k_s, k_z, v_q, v_s, v_z, base_lens,
                                  kx_q, kx_s, kx_z, vx_q, vx_s, vx_z, *, scale):
    """The chunk's rows appended after each head's live rows of a copy of
    the cache (grown by T rows, so they always fit), then
    :func:`flash_attend_int4_plain`'s causal attention."""
    from kvzip_tpu_torch.cache import append_layer_int4

    T = q.shape[0]
    layer = tuple(torch.cat([a, a.new_zeros((a.shape[0], T, *a.shape[2:]))], dim=1)
                  for a in (k_q, v_q, k_s, k_z, v_s, v_z))
    append_layer_int4(layer, base_lens, (kx_q, vx_q, kx_s, kx_z, vx_s, vx_z))
    return attention.attend_blockwise_int4(q, layer[0], layer[2], layer[3], layer[1],
                                           layer[4], layer[5], base_lens, scale=scale)


def _cache_args(what, q, k_q, k_s, k_z, v_q, v_s, v_z, base_lens):
    check_kernel_args(what, dict(q=q), dict(base_lens=base_lens),
                      dict(k_q=(k_q, torch.uint8), v_q=(v_q, torch.uint8),
                           k_s=(k_s, torch.bfloat16), k_z=(k_z, torch.bfloat16),
                           v_s=(v_s, torch.bfloat16), v_z=(v_z, torch.bfloat16)))
    T, H, _ = q.shape
    Hkv, C, Dp = k_q.shape
    if H % Hkv or H // Hkv > 32 or Dp != HEAD_DIM // 2 \
            or v_q.shape != k_q.shape or base_lens.shape != (Hkv,) \
            or any(a.shape != (Hkv, C) for a in (k_s, k_z, v_s, v_z)):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"k_q {tuple(k_q.shape)} k_s {tuple(k_s.shape)}")
    return T, H, Hkv, C


def flash_attend_int4(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                      k_z: torch.Tensor, v_q: torch.Tensor, v_s: torch.Tensor,
                      v_z: torch.Tensor, base_lens: torch.Tensor, *,
                      scale: float) -> torch.Tensor:
    """q (T, H, D); k_q/v_q (Hkv, C, D//2) uint8; k_s/k_z/v_s/v_z (Hkv, C);
    base_lens (Hkv,) int32 -> (T, H, D)."""
    args = (q, k_q, k_s, k_z, v_q, v_s, v_z, base_lens)
    if not on_cuda(*args):
        return flash_attend_int4_plain(*args, scale=scale)
    T, H, Hkv, C = _cache_args("flash_attend_int4", *args)
    if T > SPLIT_T:
        check_tma_aligned("flash_attend_int4", q=q, k_q=k_q, v_q=v_q)
    out = torch.empty_like(q)
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
    with torch.cuda.device(q.device):
        if T <= SPLIT_T:
            S, groups = plan_splits(C, Hkv, (H // Hkv) * T, sm_count(q.device))
            scratch = split_scratch(q.device, "flash_attend_int4_decode", Hkv, groups, S)
            fn = _build.kernel("flash_int4", "kvz_flash_int4_decode", _ARGS_DECODE)
            err = fn(*ptrs, *(a.data_ptr() for a in scratch), T, H, Hkv, C, S,
                     scale, stream_ptr(q.device))
        else:
            fn = _build.kernel("flash_int4", "kvz_flash_int4", _ARGS)
            err = fn(*ptrs, T, H, Hkv, C, scale, stream_ptr(q.device))
    _build.check(err, "flash_attend_int4")
    LAUNCHES["flash_attend_int4"] += 1
    if T <= SPLIT_T:
        LAUNCHES["flash_attend_int4_decode"] += 1
    return out


def flash_attend_int4_extra(q: torch.Tensor, k_q: torch.Tensor,
                            k_s: torch.Tensor, k_z: torch.Tensor,
                            v_q: torch.Tensor, v_s: torch.Tensor,
                            v_z: torch.Tensor, base_lens: torch.Tensor,
                            kx_q: torch.Tensor, kx_s: torch.Tensor,
                            kx_z: torch.Tensor, vx_q: torch.Tensor,
                            vx_s: torch.Tensor, vx_z: torch.Tensor, *,
                            scale: float) -> torch.Tensor:
    """As :func:`flash_attend_int4` with nothing appended; kx_q/vx_q
    (T, Hkv, D//2) uint8 and kx_s/kx_z/vx_s/vx_z (T, Hkv) are the chunk's
    own quantized rows -> (T, H, D)."""
    cache = (q, k_q, k_s, k_z, v_q, v_s, v_z, base_lens)
    extra = (kx_q, kx_s, kx_z, vx_q, vx_s, vx_z)
    if not on_cuda(*cache, *extra):
        return flash_attend_int4_extra_plain(*cache, *extra, scale=scale)
    T, H, Hkv, C = _cache_args("flash_attend_int4_extra", *cache)
    check_kernel_args("flash_attend_int4_extra", {}, None,
                      dict(kx_q=(kx_q, torch.uint8), vx_q=(vx_q, torch.uint8),
                           kx_s=(kx_s, torch.bfloat16), kx_z=(kx_z, torch.bfloat16),
                           vx_s=(vx_s, torch.bfloat16), vx_z=(vx_z, torch.bfloat16)))
    if kx_q.shape != (T, Hkv, HEAD_DIM // 2) or vx_q.shape != kx_q.shape \
            or any(a.shape != (T, Hkv) for a in (kx_s, kx_z, vx_s, vx_z)):
        raise ValueError(f"flash_attend_int4_extra: bad extra shapes "
                         f"{tuple(kx_q.shape)} {tuple(kx_s.shape)}")
    check_tma_aligned("flash_attend_int4_extra", q=q, k_q=k_q, v_q=v_q, kx_q=kx_q,
                      vx_q=vx_q)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = _build.kernel("flash_int4", "kvz_flash_int4_extra", _ARGS_EXTRA)
        _build.check(fn(*[a.data_ptr() for a in (*cache, *extra, out)],
                        T, H, Hkv, C, scale, stream_ptr(q.device)),
                     "flash_attend_int4_extra")
    LAUNCHES["flash_attend_int4_extra"] += 1
    return out
