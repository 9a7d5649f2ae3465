"""K4: decode attention (T <= 8) against the dense cache.

Port of ``kvzip_tpu/ops/ragged_decode.py::ragged_decode_attend``; the kernel
is ``csrc/ragged_decode.cu`` on ``csrc/split_decode.cuh``'s body (shared
with K5's decode form): one launch, a grid of at most one CTA a SM
(:func:`plan_splits`), each kv head's live rows cut on the device into S
equal splits (:func:`split_bounds` mirrors that arithmetic), and the
head's first eight splits merging all the splits' partials, a column slice
each, once the head's count of published partials is complete.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, HEAD_DIM, attention,
                                 check_kernel_args, on_cuda, sm_count,
                                 stream_ptr, ticket_buffer)

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                      ctypes.c_void_p]
MAX_T = 8
ROWS_PER_CTA = 32   # packed (query, head) rows a CTA (csrc/split_decode.cuh RG)
SPLIT_ALIGN = 16    # split lengths are multiples of a warp's 16-key tile
MERGE_FLOATS = 34816  # a merging CTA's staging (split_decode.cuh REGION / 4)


def merge_floats(rows: int, S: int) -> int:
    """The floats a merging CTA stages (``split_decode.cuh``'s launch
    check): the (m, l) rows and weights of its row group's ``min(rows,
    32)`` rows over S splits, and its column slice of every partial."""
    nr = min(rows, ROWS_PER_CTA)
    mc = 8 if S >= 8 else 4 if S >= 4 else 2 if S >= 2 else 1
    return -(-nr * S * 2 // 4) * 4 + -(-nr * S // 4) * 4 + (8 // mc) * S * nr * 16


def plan_splits(capacity: int, n_kv_heads: int, rows: int, sms: int):
    """(S, row groups) of the grid (row groups, S, n_kv_heads) of K4 and of
    K5's decode form: S splits of each head's live rows, the most that keep
    the grid within one CTA a SM (at least one) and a merging CTA's staging
    within its shared memory, and no more than the capacity's 64-key
    units."""
    groups = -(-rows // ROWS_PER_CTA)
    S = min(max(1, sms // (n_kv_heads * groups)), -(-capacity // 64))
    while S > 1 and merge_floats(rows, S) > MERGE_FLOATS:
        S -= 1
    return max(S, 1), groups


def split_scratch(device: torch.device, owner: str, n_kv_heads: int, groups: int, S: int):
    """The launch's partials: a (kv head, row group)'s S x 32 x D values
    and 32 x S (m, l) pairs (laid out in the kernel), 4 floats the merge's
    copy may read past, and the groups' arrival counts."""
    rows = n_kv_heads * groups * S * ROWS_PER_CTA
    return (torch.empty(rows * HEAD_DIM, dtype=torch.float32, device=device),
            torch.empty(rows * 2 + 4, dtype=torch.float32, device=device),
            ticket_buffer(owner, device, n_kv_heads * groups))


def split_bounds(live: int, S: int):
    """The key range [k0, k1) of each of the S splits of ``live`` rows, as
    the kernel computes it: equal lengths rounded up to ``SPLIT_ALIGN``."""
    per = -(-live // S)
    chunk = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return [(min(s * chunk, live), min(s * chunk + chunk, live)) for s in range(S)]


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
    S, groups = plan_splits(C, Hkv, R, sm_count(q.device))
    out = torch.empty_like(q)
    part_acc, part_ml, tickets = split_scratch(q.device, "ragged_decode_attend", Hkv,
                                               groups, S)
    with torch.cuda.device(q.device):
        fn = _build.kernel("ragged_decode", "kvz_ragged_decode", _ARGS)
        _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        base_lens.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                        part_ml.data_ptr(), tickets.data_ptr(), T, H, Hkv, C, S, scale,
                        stream_ptr(q.device)), "ragged_decode_attend")
    LAUNCHES["ragged_decode_attend"] += 1
    return out
