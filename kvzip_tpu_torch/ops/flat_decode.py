"""K10 and K11: decode attention over the FLAT cache (after eviction, with
``Engine(flat_decode="legacy")``).

Port of ``kvzip_tpu/ops/flat_decode.py::flat_decode_attend`` (K10, bf16
rows, ``csrc/flat_decode.cu``: K3's one launch, the bf16 mode of
``csrc/int4_decode.cuh``) and ``::flat_decode_attend_int4`` (K11, int4
rows, exact or ``q8``, ``csrc/flat_decode_int4.cu``: K7's one launch on
the same body), each with the merge inside the launch and planned by
``ops/int4_decode.py``, with the reference's calling convention: stacked
``(L, ...)`` flat arrays plus a ``layer`` index (or one layer's arrays and
``layer=None``), the layer's tail, ``tail_len`` one int or one per
(sequence, kv head), and ``n_seq`` sequences merged seq-major (query
heads, flat rows and tails alike; each sequence's flat rows are an equal
segment of ``R_pad // n_seq``). ``seg_rows`` (the flat caches'
``seg_rows``), where given, is each (layer, sequence) segment's count of
live rows, which come first in it: the kernels read no row past it. The
plain versions mask the padding and need no count.

Semantics: query row ``r`` of sequence ``sb`` (head-major, ``r = h * T + i``)
belongs to kv head ``(r // T) // G + sb * Hkv``; a flat row is visible iff
its ``row_head`` equals that head; tail row ``j`` of head ``h`` is visible to
query ``i`` iff ``j < tail_len[h] + i + 1``; float32 softmax, the output
divided by ``max(l, 1e-37)``. The port keeps K row-major like V.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args, int4_decode,
                                 on_cuda, sm_count, stream_ptr)
from kvzip_tpu_torch.ops.attention import Q8_TILE, attend_int4_q8
from kvzip_tpu_torch.ops.quant import dequantize_int4

_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                       ctypes.c_void_p]
_ARGS_INT4 = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12 + [ctypes.c_float,
                                                             ctypes.c_void_p]
TailLen = Union[int, torch.Tensor]


def _tail_lens(tail_len: TailLen, n: int) -> list:
    """tail_len as one int per (sequence, kv head)."""
    if isinstance(tail_len, torch.Tensor) and tail_len.dim() > 0:
        return [int(v) for v in tail_len.tolist()]
    return [int(tail_len)] * n


def _flat_heads(q, row_head, k_tail, tail_len, n_seq, attend, with_slack=False):
    """Loop of the plain versions over (sequence, kv head): ``attend(qr,
    seg, visible, hg, tail_ok)`` gives the (G*T, D) float32 attention of
    the head's query rows qr (row g*T + i) over its sequence's segment
    ``seg`` of flat rows (``visible`` its rows) and tail ``hg`` (with
    ``with_slack``, and its q8 slack of the same shape, returned beside the
    output)."""
    T, H_all, D = q.shape
    Hkv_all, Tcap = k_tail.shape[0], k_tail.shape[1]
    Hkv, H = Hkv_all // n_seq, H_all // n_seq
    G = H // Hkv
    R = row_head.shape[-1] // n_seq
    lens = _tail_lens(tail_len, Hkv_all)
    out = torch.empty((T, H_all, D), dtype=torch.float32, device=q.device)
    slack = torch.zeros((T, H_all, D), dtype=torch.float32, device=q.device)
    qi = torch.arange(G * T, device=q.device) % T
    col = torch.arange(Tcap, device=q.device)
    for hg in range(Hkv_all):
        sb = hg // Hkv
        seg = slice(sb * R, (sb + 1) * R)
        tail_ok = col[None] < lens[hg] + qi[:, None] + 1
        o = attend(attention.head_rows(q, hg, G), seg, row_head[seg] == hg, hg, tail_ok)
        if with_slack:
            o, sl = o
            attention.put_head_rows(slack, hg, G, sl)
        attention.put_head_rows(out, hg, G, o)
    return (out.to(q.dtype), slack) if with_slack else out.to(q.dtype)


def _layer(layer, *arrays):
    return arrays if layer is None else tuple(a[layer] for a in arrays)


def flat_decode_attend_plain(q, k_flat, v_flat, row_head, k_tail, v_tail, tail_len,
                             *, scale, n_seq=1, layer=None, seg_rows=None):
    k_flat, v_flat, row_head = _layer(layer, k_flat, v_flat, row_head)

    def attend(qr, seg, visible, hg, tail_ok):
        return attention.attend_rows(qr, k_flat[seg][visible], v_flat[seg][visible],
                                     k_tail[hg], v_tail[hg], tail_ok, scale=scale)

    return _flat_heads(q, row_head, k_tail, tail_len, n_seq, attend)


def flat_decode_attend_int4_plain(q, k_flat_q, k_flat_s, k_flat_z, v_flat_q, v_flat_s,
                                  v_flat_z, row_head, k_tail, v_tail, tail_len, *, scale,
                                  q8=False, n_seq=1, layer=None, seg_rows=None,
                                  block=Q8_TILE, with_slack=False):
    """Exact: the visible rows dequantized in float32, then K10's plain
    attention. ``q8``: ``attention.attend_int4_q8`` over the sequence's
    segment, p quantized per ``block`` rows from the segment's row 0; with
    ``with_slack`` it also returns the output's q8 slack (T, H, D)."""
    if with_slack and not q8:
        raise ValueError("with_slack is the q8 mode's")
    arrays = _layer(layer, k_flat_q, k_flat_s, k_flat_z, v_flat_q, v_flat_s, v_flat_z,
                    row_head)
    row_head = arrays[-1]

    def attend(qr, seg, visible, hg, tail_ok):
        kq, ks, kz, vq, vs, vz = (a[seg] for a in arrays[:-1])
        if q8:
            return attend_int4_q8(qr, kq, ks.float(), kz.float(), vq, vs.float(), vz.float(),
                                  visible, k_tail[hg], v_tail[hg], tail_ok, scale=scale,
                                  block=block, with_slack=with_slack)
        k_rows, v_rows = (dequantize_int4(p[visible], s[visible, None], z[visible, None],
                                          torch.float32, pack="split")
                          for p, s, z in ((kq, ks, kz), (vq, vs, vz)))
        return attention.attend_rows(qr, k_rows, v_rows, k_tail[hg], v_tail[hg], tail_ok,
                                     scale=scale)

    return _flat_heads(q, row_head, k_tail, tail_len, n_seq, attend, with_slack)


def tail_arg(tail_len: TailLen, n_heads: int, T: int, Tcap: int, device,
             what: str, check: bool = True) -> tuple:
    """A kernel's tail length: (the ``(n_heads,)`` int32 vector or None, the
    one int). The largest entry must leave room for the T new rows; a
    vector's entries are read back for that check (a host sync), except
    with ``check=False`` (the caller has checked: the model's forward, whose
    engine checks the room once a generate) or while a CUDA graph is being
    captured, where the kernels' clamp of each head's rows at Tcap still
    keeps every read inside the tail."""
    if isinstance(tail_len, torch.Tensor) and tail_len.dim() > 0:
        if tail_len.shape != (n_heads,) or tail_len.dtype != torch.int32 \
                or tail_len.device != device or not tail_len.is_contiguous():
            raise ValueError(f"{what}: tail_len must be ({n_heads},) int32 on {device}")
        if not check or (tail_len.is_cuda and torch.cuda.is_current_stream_capturing()):
            return tail_len, 0
        lo, hi = torch.stack([tail_len.min(), tail_len.max()]).tolist()
        if hi + T > Tcap or lo < 0:
            raise ValueError(f"{what}: tail_len max {hi} + T {T} > Tcap {Tcap}")
        return tail_len, 0
    scalar = int(tail_len)
    if scalar + T > Tcap:
        raise ValueError(f"{what}: tail_len {scalar} + T {T} > Tcap {Tcap}")
    return None, scalar


def _launch_geometry(q, k_tail, rows_total, n_seq, layer, L, what, tail_len, seg_rows,
                     check_tail):
    """Shared checks and geometry of K10/K11's launch: (T, H_all, Hkv, Tcap,
    R_seg, tail pointer, tail scalar, seg_rows pointer, layer), Hkv per
    sequence."""
    T, H_all, D = q.shape
    Hkv_all, Tcap, _ = k_tail.shape
    stacked = layer is not None
    layer = 0 if layer is None else int(layer)
    if n_seq < 1 or H_all % n_seq or Hkv_all % n_seq or (H_all // n_seq) % (Hkv_all // n_seq) \
            or rows_total % n_seq or not 0 <= layer < L:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} tail {tuple(k_tail.shape)} "
                         f"rows {rows_total} n_seq {n_seq} layer {layer}")
    if seg_rows is not None and (
            seg_rows.shape != ((L, n_seq) if stacked else (n_seq,))
            or seg_rows.dtype != torch.int32 or seg_rows.device != q.device
            or not seg_rows.is_contiguous()):
        raise ValueError(f"{what}: seg_rows must be {(L, n_seq) if stacked else (n_seq,)} "
                         f"int32 on {q.device}, got {tuple(seg_rows.shape)} {seg_rows.dtype}")
    lens_t, scalar = tail_arg(tail_len, Hkv_all, T, Tcap, q.device, what, check_tail)
    return (T, H_all, Hkv_all // n_seq, Tcap, rows_total // n_seq,
            lens_t.data_ptr() if lens_t is not None else None, scalar,
            seg_rows.data_ptr() if seg_rows is not None else None, layer)


def flat_decode_attend(q: torch.Tensor, k_flat: torch.Tensor, v_flat: torch.Tensor,
                       row_head: torch.Tensor, k_tail: torch.Tensor, v_tail: torch.Tensor,
                       tail_len: TailLen, *, scale: float, n_seq: int = 1,
                       layer: Optional[int] = None,
                       seg_rows: Optional[torch.Tensor] = None,
                       check_tail: bool = True) -> torch.Tensor:
    """q (T, n_seq*H, D); k_flat/v_flat ([L,] R_pad, D); row_head ([L,]
    R_pad) int32 (-1 padding); k_tail/v_tail (n_seq*Hkv, Tcap, D), this
    layer's, with this step's T rows already written at ``tail_len``;
    ``layer`` selects the layer of stacked flat arrays; ``seg_rows`` ([L,]
    n_seq) int32, the live rows a segment; ``check_tail=False``: a tail
    vector is not read back (``tail_arg``) -> (T, n_seq*H, D)."""
    if not on_cuda(q, k_flat, v_flat, row_head, k_tail, v_tail):
        return flat_decode_attend_plain(q, k_flat, v_flat, row_head, k_tail, v_tail, tail_len,
                                        scale=scale, n_seq=n_seq, layer=layer)
    what = "flat_decode_attend"
    check_kernel_args(what, dict(q=q, k_flat=k_flat, v_flat=v_flat, k_tail=k_tail,
                                 v_tail=v_tail), dict(row_head=row_head))
    stacked = layer is not None
    if k_flat.dim() != 2 + stacked or v_flat.shape != k_flat.shape \
            or row_head.shape != k_flat.shape[:-1] or v_tail.shape != k_tail.shape:
        raise ValueError(f"{what}: bad shapes flat {tuple(k_flat.shape)} "
                         f"row_head {tuple(row_head.shape)} tail {tuple(k_tail.shape)}")
    L = k_flat.shape[0] if stacked else 1
    (T, H_all, Hkv, Tcap, R_seg, lens_ptr, scalar, seg_ptr,
     layer) = _launch_geometry(q, k_tail, k_flat.shape[-2], n_seq, layer, L, what, tail_len,
                               seg_rows, check_tail)
    mtc, groups, S = int4_decode.plan(H_all // n_seq * T, n_seq, R_seg, sm_count(q.device),
                                      int4_decode.BF_TILE)
    out = torch.empty_like(q)
    part_acc, part_ml, tickets = int4_decode.scratch(q.device, what, n_seq, groups, S, mtc)
    with torch.cuda.device(q.device):
        fn = _build.kernel("flat_decode", "kvz_flat_decode", _ARGS)
        _build.check(fn(q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), row_head.data_ptr(),
                        seg_ptr, k_tail.data_ptr(), v_tail.data_ptr(), lens_ptr, out.data_ptr(),
                        part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), T, H_all,
                        Hkv, n_seq, Tcap, layer, R_seg, scalar, S, mtc, groups, scale,
                        stream_ptr(q.device)), what)
    LAUNCHES[what] += 1
    return out


def flat_decode_attend_int4(q: torch.Tensor, k_flat_q: torch.Tensor, k_flat_s: torch.Tensor,
                            k_flat_z: torch.Tensor, v_flat_q: torch.Tensor,
                            v_flat_s: torch.Tensor, v_flat_z: torch.Tensor,
                            row_head: torch.Tensor, k_tail: torch.Tensor,
                            v_tail: torch.Tensor, tail_len: TailLen, *, scale: float,
                            q8: bool = False, n_seq: int = 1, layer: Optional[int] = None,
                            seg_rows: Optional[torch.Tensor] = None,
                            check_tail: bool = True) -> torch.Tensor:
    """As :func:`flat_decode_attend` over int4 rows: k/v_flat_q ([L,] R_pad,
    D//2) uint8 split-packed, k/v_flat_s/z ([L,] R_pad) float32. ``q8``:
    the int8-attention mode (``attention.attend_int4_q8``)."""
    flat = (k_flat_q, k_flat_s, k_flat_z, v_flat_q, v_flat_s, v_flat_z)
    if not on_cuda(q, *flat, row_head, k_tail, v_tail):
        return flat_decode_attend_int4_plain(q, *flat, row_head, k_tail, v_tail, tail_len,
                                             scale=scale, q8=q8, n_seq=n_seq, layer=layer)
    what = "flat_decode_attend_int4"
    check_kernel_args(what, dict(q=q, k_tail=k_tail, v_tail=v_tail),
                      dict(row_head=row_head),
                      {n: (t, torch.uint8 if n.endswith("q") else torch.float32)
                       for n, t in zip(("k_flat_q", "k_flat_s", "k_flat_z", "v_flat_q",
                                        "v_flat_s", "v_flat_z"), flat)})
    stacked = layer is not None
    D = q.shape[-1]
    rows_shape = row_head.shape
    if row_head.dim() != 1 + stacked or v_tail.shape != k_tail.shape \
            or any(a.shape != (*rows_shape, D // 2) for a in (k_flat_q, v_flat_q)) \
            or any(a.shape != rows_shape for a in (k_flat_s, k_flat_z, v_flat_s, v_flat_z)):
        raise ValueError(f"{what}: bad shapes flat {tuple(k_flat_q.shape)} "
                         f"row_head {tuple(rows_shape)} tail {tuple(k_tail.shape)}")
    L = rows_shape[0] if stacked else 1
    (T, H_all, Hkv, Tcap, R_seg, lens_ptr, scalar, seg_ptr,
     layer) = _launch_geometry(q, k_tail, rows_shape[-1], n_seq, layer, L, what, tail_len,
                               seg_rows, check_tail)
    mtc, groups, S = int4_decode.plan(H_all // n_seq * T, n_seq, R_seg, sm_count(q.device))
    out = torch.empty_like(q)
    part_acc, part_ml, tickets = int4_decode.scratch(q.device, what, n_seq, groups, S, mtc)
    with torch.cuda.device(q.device):
        fn = _build.kernel("flat_decode_int4", "kvz_flat_decode_int4", _ARGS_INT4)
        _build.check(fn(*[a.data_ptr() for a in (q, *flat, row_head)], seg_ptr,
                        k_tail.data_ptr(), v_tail.data_ptr(), lens_ptr, out.data_ptr(),
                        part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), T, H_all,
                        Hkv, n_seq, Tcap, layer, R_seg, scalar, S, mtc, groups, int(q8), scale,
                        stream_ptr(q.device)), what)
    LAUNCHES["flat_decode_attend_int4_q8" if q8 else "flat_decode_attend_int4"] += 1
    return out
