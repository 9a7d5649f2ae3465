"""K3 and K7: decode attention over the POOL cache (after eviction).

Port of ``kvzip_tpu/ops/pool_decode.py::pool_decode_attend`` (K3, bf16
pool, ``csrc/pool_decode.cu``) and ``::pool_decode_attend_int4`` (K7, int4
pool, exact or the int8-attention ``q8`` mode, ``csrc/pool_decode_int4.cu``):
each one launch of ``csrc/int4_decode.cuh``'s body (its bf16 mode for K3),
planned by ``ops/int4_decode.py``, with the merge inside it. The port stores the
pool row-major: K and V are both (P, D), or (P, D//2) packed int4 rows with
float32 per-row scales and zeros (P,). ``tail_len`` is one int or one per
kv head (an ``(Hkv,)`` int32 tensor on q's device, as the merged pool of
serving passes it): tail row j of head h is visible to query i iff
``j < tail_len[h] + i + 1``.
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args, int4_decode,
                                 on_cuda, sm_count, stream_ptr)
from kvzip_tpu_torch.ops.attention import Q8_TILE, attend_int4_q8
from kvzip_tpu_torch.ops.flat_decode import TailLen, _tail_lens, tail_arg
from kvzip_tpu_torch.ops.quant import dequantize_int4

_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                       ctypes.c_void_p]
_ARGS_INT4 = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                             ctypes.c_void_p]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tail_masks(tail_len: TailLen, T: int, G: int, Hkv: int, Tcap: int, device) -> list:
    """Per kv head, the (G*T, Tcap) visibility of its tail rows to the
    head's query rows (row g*T + i)."""
    qi = torch.arange(G * T, device=device) % T
    col = torch.arange(Tcap, device=device)
    return [col[None] < n + qi[:, None] + 1 for n in _tail_lens(tail_len, Hkv)]


def pool_decode_attend_plain(q, k_pool, v_pool, row_head, layer_off,
                             layer_rows, k_tail, v_tail, tail_len, layer, *,
                             scale):
    off, n = int(layer_off[layer]), int(layer_rows[layer])
    return _pool_layer_plain(q, k_pool[off:off + n].float(),
                             v_pool[off:off + n].float(), row_head[off:off + n],
                             k_tail, v_tail, tail_len, layer, scale=scale)


def pool_decode_attend_int4_plain(q, k_pool_q, k_pool_s, k_pool_z, v_pool_q,
                                  v_pool_s, v_pool_z, row_head, layer_off,
                                  layer_rows, k_tail, v_tail, tail_len, layer,
                                  *, scale, q8=False, block=Q8_TILE, with_slack=False):
    """Exact: the layer's pool rows dequantized in float32, then K3's plain
    attention. ``q8``: ``attention.attend_int4_q8`` over the layer's
    segment, p quantized per ``block`` rows from ``layer_off``; with
    ``with_slack`` it also returns the output's q8 slack (T, H, D)."""
    if with_slack and not q8:
        raise ValueError("with_slack is the q8 mode's")
    off, n = int(layer_off[layer]), int(layer_rows[layer])
    seg = (k_pool_q, k_pool_s, k_pool_z, v_pool_q, v_pool_s, v_pool_z)
    if q8:
        T, H, D = q.shape
        Hkv, Tcap = k_tail.shape[1], k_tail.shape[2]
        G = H // Hkv
        kq, ks, kz, vq, vs, vz = (a[off:off + n] for a in seg)
        tail_ok = _tail_masks(tail_len, T, G, Hkv, Tcap, q.device)
        out = torch.empty((T, H, D), dtype=torch.float32, device=q.device)
        slack = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
        for h in range(Hkv):
            o, sl = attend_int4_q8(attention.head_rows(q, h, G), kq, ks.float(), kz.float(),
                                   vq, vs.float(), vz.float(), row_head[off:off + n] == h,
                                   k_tail[layer, h], v_tail[layer, h], tail_ok[h], scale=scale,
                                   block=block, with_slack=True)
            attention.put_head_rows(out, h, G, o)
            attention.put_head_rows(slack, h, G, sl)
        return (out.to(q.dtype), slack) if with_slack else out.to(q.dtype)
    kp, vp = (dequantize_int4(p[off:off + n], s[off:off + n, None],
                              z[off:off + n, None], torch.float32, pack="split")
              for p, s, z in ((k_pool_q, k_pool_s, k_pool_z),
                              (v_pool_q, v_pool_s, v_pool_z)))
    return _pool_layer_plain(q, kp, vp, row_head[off:off + n], k_tail, v_tail,
                             tail_len, layer, scale=scale)


def _pool_layer_plain(q, kp, vp, rh, k_tail, v_tail, tail_len, layer, *,
                      scale):
    """Attention of q over one layer's pool rows kp/vp (n, D) with their kv
    heads rh (n,), and the layer's tail."""
    T, H, D = q.shape
    Hkv, Tcap = k_tail.shape[1], k_tail.shape[2]
    G = H // Hkv
    tail_ok = _tail_masks(tail_len, T, G, Hkv, Tcap, q.device)
    out = torch.empty((T, H, D), dtype=torch.float32, device=q.device)
    for h in range(Hkv):
        mine = rh == h
        attention.put_head_rows(out, h, G, attention.attend_rows(
            attention.head_rows(q, h, G), kp[mine], vp[mine], k_tail[layer, h],
            v_tail[layer, h], tail_ok[h], scale=scale))
    return out.to(q.dtype)


def pool_decode_attend(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, row_head: torch.Tensor,
                       layer_off: torch.Tensor, layer_rows: torch.Tensor,
                       k_tail: torch.Tensor, v_tail: torch.Tensor,
                       tail_len: TailLen, layer: int, *, scale: float,
                       max_rows: int, check_tail: bool = True) -> torch.Tensor:
    """q (T, H, D); k_pool/v_pool (P, D); row_head (P,) int32 (-1 padding);
    layer_off/layer_rows (L,) int32; k_tail/v_tail (L, Hkv, Tcap, D) with
    this step's T rows already written at ``tail_len``; ``max_rows`` bounds
    every layer's live rows; ``check_tail=False``: a tail vector is not read
    back (``flat_decode.tail_arg``) -> (T, H, D)."""
    if not on_cuda(q, k_pool, v_pool, row_head, layer_off, layer_rows,
                   k_tail, v_tail):
        return pool_decode_attend_plain(q, k_pool, v_pool, row_head,
                                        layer_off, layer_rows, k_tail, v_tail,
                                        tail_len, layer, scale=scale)
    check_kernel_args("pool_decode_attend",
                      dict(q=q, k_pool=k_pool, v_pool=v_pool, k_tail=k_tail,
                           v_tail=v_tail),
                      dict(row_head=row_head, layer_off=layer_off,
                           layer_rows=layer_rows))
    T, H, D = q.shape
    L, Hkv, Tcap, _ = k_tail.shape
    if H % Hkv or v_pool.shape != k_pool.shape or v_tail.shape != k_tail.shape \
            or row_head.shape != (k_pool.shape[0],) or not 0 <= layer < L:
        raise ValueError(f"pool_decode_attend: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} tail {tuple(k_tail.shape)}")
    lens_t, scalar = tail_arg(tail_len, Hkv, T, Tcap, q.device, "pool_decode_attend",
                              check_tail)
    mtc, groups, S = int4_decode.plan(H * T, 1, max_rows, sm_count(q.device),
                                      int4_decode.BF_TILE)
    out = torch.empty_like(q)
    part_acc, part_ml, tickets = int4_decode.scratch(q.device, "pool_decode_attend", 1,
                                                     groups, S, mtc)
    with torch.cuda.device(q.device):
        fn = _build.kernel("pool_decode", "kvz_pool_decode", _ARGS)
        _build.check(fn(*[a.data_ptr() for a in (q, k_pool, v_pool, row_head, layer_off,
                                                 layer_rows, k_tail, v_tail)],
                        _ptr(lens_t), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                        tickets.data_ptr(), T, H, Hkv, Tcap, layer, scalar, S, mtc, groups,
                        scale, stream_ptr(q.device)), "pool_decode_attend")
    LAUNCHES["pool_decode_attend"] += 1
    return out


def pool_decode_attend_int4(q: torch.Tensor, k_pool_q: torch.Tensor,
                            k_pool_s: torch.Tensor, k_pool_z: torch.Tensor,
                            v_pool_q: torch.Tensor, v_pool_s: torch.Tensor,
                            v_pool_z: torch.Tensor, row_head: torch.Tensor,
                            layer_off: torch.Tensor, layer_rows: torch.Tensor,
                            k_tail: torch.Tensor, v_tail: torch.Tensor,
                            tail_len: TailLen, layer: int, *, scale: float,
                            max_rows: int, q8: bool = False,
                            check_tail: bool = True) -> torch.Tensor:
    """As :func:`pool_decode_attend` over an int4 pool: k_pool_q/v_pool_q
    (P, D//2) uint8 split-packed, k/v_pool_s/z (P,) float32 -> (T, H, D).
    ``q8``: the int8-attention mode (``attention.attend_int4_q8``)."""
    pool = (k_pool_q, k_pool_s, k_pool_z, v_pool_q, v_pool_s, v_pool_z)
    meta = (row_head, layer_off, layer_rows)
    if not on_cuda(q, *pool, *meta, k_tail, v_tail):
        return pool_decode_attend_int4_plain(q, *pool, *meta, k_tail, v_tail,
                                             tail_len, layer, scale=scale, q8=q8)
    check_kernel_args("pool_decode_attend_int4",
                      dict(q=q, k_tail=k_tail, v_tail=v_tail),
                      dict(row_head=row_head, layer_off=layer_off,
                           layer_rows=layer_rows),
                      {n: (t, torch.uint8 if n.endswith("q") else torch.float32)
                       for n, t in zip(("k_pool_q", "k_pool_s", "k_pool_z",
                                        "v_pool_q", "v_pool_s", "v_pool_z"), pool)})
    T, H, D = q.shape
    L, Hkv, Tcap, _ = k_tail.shape
    P = k_pool_q.shape[0]
    if H % Hkv or k_pool_q.shape != (P, D // 2) \
            or v_pool_q.shape != (P, D // 2) \
            or any(a.shape != (P,) for a in (k_pool_s, k_pool_z, v_pool_s,
                                             v_pool_z, row_head)) \
            or v_tail.shape != k_tail.shape or not 0 <= layer < L:
        raise ValueError(f"pool_decode_attend_int4: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool_q.shape)} tail {tuple(k_tail.shape)}")
    lens_t, scalar = tail_arg(tail_len, Hkv, T, Tcap, q.device, "pool_decode_attend_int4",
                              check_tail)
    mtc, groups, S = int4_decode.plan(H * T, 1, max_rows, sm_count(q.device))
    out = torch.empty_like(q)
    part_acc, part_ml, tickets = int4_decode.scratch(q.device, "pool_decode_attend_int4", 1,
                                                     groups, S, mtc)
    with torch.cuda.device(q.device):
        fn = _build.kernel("pool_decode_int4", "kvz_pool_decode_int4", _ARGS_INT4)
        _build.check(fn(*[a.data_ptr() for a in (q, *pool, *meta, k_tail, v_tail)],
                        _ptr(lens_t), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                        tickets.data_ptr(), T, H, Hkv, Tcap, layer, scalar, S, mtc, groups,
                        int(q8), scale, stream_ptr(q.device)), "pool_decode_attend_int4")
    LAUNCHES["pool_decode_attend_int4_q8" if q8 else "pool_decode_attend_int4"] += 1
    return out
