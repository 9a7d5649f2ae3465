"""K2: fused KVzip reconstruction scores (the scoring hook).

Port of ``kvzip_tpu/ops/score_kernel.py::fused_scores``; the kernel is
``csrc/score.cu``. ``keys`` is ``[sink | ctx window | repeat]``.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args,
                                 on_cuda, stream_ptr)

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                      ctypes.c_void_p]


def fused_scores_plain(q, keys, ctx_len, q_valid, *, sink, s_ctx, scale,
                       model_dtype):
    s0 = sink + s_ctx
    return attention.reconstruction_scores(
        q, keys[:, :sink], keys[:, sink:s0], keys[:, s0:].transpose(0, 1),
        ctx_len, scale=scale, q_valid=q_valid, model_dtype=model_dtype)


def fused_scores(q: torch.Tensor, keys: torch.Tensor, ctx_len: int,
                 q_valid: int, *, sink: int, s_ctx: int, scale: float,
                 model_dtype: torch.dtype) -> torch.Tensor:
    """q (T, H, D) repeat-pass queries; keys (Hkv, sink + s_ctx + T, D);
    returns (Hkv, s_ctx) float32 scores, zero past ``ctx_len``."""
    if not on_cuda(q, keys):
        return fused_scores_plain(q, keys, ctx_len, q_valid, sink=sink,
                                  s_ctx=s_ctx, scale=scale,
                                  model_dtype=model_dtype)
    if model_dtype != torch.bfloat16:
        raise TypeError("fused_scores kernel rounds logits to bfloat16 only")
    check_kernel_args("fused_scores", dict(q=q, keys=keys))
    T, H, D = q.shape
    Hkv, K, _ = keys.shape
    if H % Hkv or H // Hkv > 32 or K != sink + s_ctx + T:
        raise ValueError(f"fused_scores: bad shapes q {tuple(q.shape)} "
                         f"keys {tuple(keys.shape)}")
    out = torch.empty((Hkv, s_ctx), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        fn = _build.kernel("score", "kvz_fused_scores", _ARGS)
        _build.check(fn(q.data_ptr(), keys.data_ptr(), out.data_ptr(), T, H,
                        Hkv, K, sink, s_ctx, int(ctx_len), int(q_valid), scale,
                        stream_ptr(q.device)), "fused_scores")
    LAUNCHES["fused_scores"] += 1
    return out
