"""K9: attention output of the windowed scoring pass.

Port of ``kvzip_tpu/ops/windowed_attend.py``; the kernel is
``csrc/windowed_attend.cu`` (K1's TMA and wgmma body, ``csrc/flash_sm90.cuh``,
over the live 128-key tiles). ``keys``/``vals`` are
``[sink | ctx window | repeat]`` per kv head; masks as in
``attention.windowed_scoring_attend``, its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args,
                                 check_tma_aligned, on_cuda, stream_ptr)

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                      ctypes.c_void_p]


def windowed_attend_plain(q, keys, vals, ctx_len, *, sink, s_ctx, scale):
    s0 = sink + s_ctx
    return attention.windowed_scoring_attend(
        q, keys[:, :sink], keys[:, sink:s0], keys[:, s0:].transpose(0, 1),
        vals[:, :sink], vals[:, sink:s0], vals[:, s0:].transpose(0, 1),
        ctx_len, scale=scale, out_dtype=q.dtype)


def windowed_attend(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                    ctx_len: int, *, sink: int, s_ctx: int,
                    scale: float) -> torch.Tensor:
    """q (T, H, D) repeat-pass queries; keys/vals (Hkv, sink + s_ctx + T,
    D); ``ctx_len`` the true window length -> (T, H, D)."""
    if not on_cuda(q, keys, vals):
        return windowed_attend_plain(q, keys, vals, ctx_len, sink=sink,
                                     s_ctx=s_ctx, scale=scale)
    check_kernel_args("windowed_attend", dict(q=q, keys=keys, vals=vals))
    T, H, D = q.shape
    Hkv, K, _ = keys.shape
    if H % Hkv or H // Hkv > 32 or K != sink + s_ctx + T \
            or vals.shape != keys.shape or not 0 < ctx_len <= s_ctx:
        raise ValueError(f"windowed_attend: bad shapes q {tuple(q.shape)} keys "
                         f"{tuple(keys.shape)} vals {tuple(vals.shape)} sink "
                         f"{sink} s_ctx {s_ctx} ctx_len {ctx_len}")
    check_tma_aligned("windowed_attend", q=q, keys=keys, vals=vals)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = _build.kernel("windowed_attend", "kvz_windowed_attend", _ARGS)
        _build.check(fn(q.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                        out.data_ptr(), T, H, Hkv, K, sink, s_ctx, int(ctx_len),
                        scale, stream_ptr(q.device)), "windowed_attend")
    LAUNCHES["windowed_attend"] += 1
    return out


def windowed_scoring_attend_fused(q, k_sink, k_ctx, k_rep, v_sink, v_ctx,
                                  v_rep, ctx_len, *, scale,
                                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """``attention.windowed_scoring_attend`` (same arguments) through
    :func:`windowed_attend`: the keys and values concatenated per kv
    head."""
    sink, s_ctx = k_sink.shape[1], k_ctx.shape[1]
    keys = torch.cat([k_sink, k_ctx, k_rep.transpose(0, 1)], dim=1)
    vals = torch.cat([v_sink, v_ctx, v_rep.transpose(0, 1)], dim=1)
    return windowed_attend(q.to(out_dtype), keys.to(out_dtype),
                           vals.to(out_dtype), ctx_len, sink=sink, s_ctx=s_ctx,
                           scale=scale).to(out_dtype)
