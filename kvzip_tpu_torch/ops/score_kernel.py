"""K2: fused KVzip reconstruction scores (the scoring hook).

Port of ``kvzip_tpu/ops/score_kernel.py::fused_scores``; the kernel is
``csrc/score.cu``: one CTA per (kv head, block of ``nq`` queries) holding
the Q rows of all G heads of its block (:func:`plan` picks ``nq``), K tiles
streamed by TMA through a ring, ``wgmma`` q.k, a first pass for each row's
max and denominator and a second over the window tiles for the column
maxima. :func:`tile_plan` mirrors the tiles a CTA visits. ``keys`` is
``[sink | ctx window | repeat]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args,
                                 check_tma_aligned, on_cuda, sm_count,
                                 stream_ptr)

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                      ctypes.c_void_p]
KEY_TILE = 128      # keys a tile (csrc/score.cu, fsm90::BKT)
MAX_ROWS = 256      # (query, head) rows a CTA: four 64-row wgmma tiles
CONSUMERS = 2       # consumer warpgroups a CTA, each taking every other row tile


@functools.lru_cache(maxsize=None)
def plan(G: int, n_kv_heads: int, q_valid: int, sms: int, max_rows: int = MAX_ROWS) -> int:
    """Queries a CTA (``nq``): the grid is (n_kv_heads, ceil(q_valid / nq))
    of one CTA a SM, and a CTA's time grows with the 64-row tiles its
    busier consumer warpgroup takes. The nq of least waves x tiles a
    warpgroup, the largest of equals (each K tile is then read by fewer
    CTAs); nq G <= ``max_rows``, nq <= 256 (a TMA box dimension) and
    nq <= q_valid."""
    best = None
    for nq in range(1, min(256, max_rows // G, q_valid) + 1):
        waves = -(-n_kv_heads * -(-q_valid // nq) // sms)
        tiles = -(-nq * G // 64)
        cost = waves * -(-tiles // CONSUMERS)
        if best is None or cost <= best[0]:
            best = (cost, nq)
    return best[1]


def tile_plan(sink: int, s_ctx: int, ctx_len: int, q0: int,
              q_end: int) -> List[Tuple[int, int, bool]]:
    """The tiles a CTA of queries [q0, q_end) visits, in order, as
    (pass, first key column, masked): pass 1 the tiles of [0, sink +
    ctx_len) from column 0, then the repeat block's tiles from its start
    up to the block's last query; pass 2 the window tiles from column
    ``sink``. ``masked`` is False only where every query of the block sees
    every column of the tile (pass 2 always masks: it drops the queries
    past q_valid)."""
    lim_a, s0 = sink + ctx_len, sink + s_ctx
    n_a = -(-lim_a // KEY_TILE)
    out = [(1, i * KEY_TILE, (i + 1) * KEY_TILE > lim_a) for i in range(n_a)]
    out += [(1, s0 + j * KEY_TILE, (j + 1) * KEY_TILE > q0 + 1)
            for j in range(-(-q_end // KEY_TILE))]
    out += [(2, sink + j * KEY_TILE, True) for j in range(-(-ctx_len // KEY_TILE))]
    return out


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
    check_tma_aligned("fused_scores", q=q, keys=keys)
    T, H, D = q.shape
    Hkv, K, _ = keys.shape
    if H % Hkv or H // Hkv > 32 or K != sink + s_ctx + T:
        raise ValueError(f"fused_scores: bad shapes q {tuple(q.shape)} "
                         f"keys {tuple(keys.shape)}")
    ctx_len, q_valid = min(int(ctx_len), s_ctx), min(int(q_valid), T)
    if ctx_len <= 0 or q_valid <= 0:  # no window column or no query: all zero
        return torch.zeros((Hkv, s_ctx), dtype=torch.float32, device=q.device)
    out = torch.empty((Hkv, s_ctx), dtype=torch.float32, device=q.device)
    nq = plan(H // Hkv, Hkv, q_valid, sm_count(q.device))
    with torch.cuda.device(q.device):
        fn = _build.kernel("score", "kvz_fused_scores", _ARGS)
        _build.check(fn(q.data_ptr(), keys.data_ptr(), out.data_ptr(), T, H,
                        Hkv, K, sink, s_ctx, ctx_len, q_valid, nq, scale,
                        stream_ptr(q.device)), "fused_scores")
    LAUNCHES["fused_scores"] += 1
    return out
