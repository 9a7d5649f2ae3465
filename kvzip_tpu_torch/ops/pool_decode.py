"""K3: decode attention over the POOL cache (after eviction).

Port of ``kvzip_tpu/ops/pool_decode.py::pool_decode_attend``; the kernel is
``csrc/pool_decode.cu`` (flash-decoding over the layer's pool segment plus
one split for the tail, then a merge). The port stores the pool row-major:
K and V are both (P, D).
"""

from __future__ import annotations

import ctypes

import torch

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, attention, check_kernel_args,
                                 on_cuda, stream_ptr)
from kvzip_tpu_torch.ops.ragged_decode import split_size

_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                       ctypes.c_void_p]


def pool_decode_attend_plain(q, k_pool, v_pool, row_head, layer_off,
                             layer_rows, k_tail, v_tail, tail_len, layer, *,
                             scale):
    T, H, D = q.shape
    Hkv, Tcap = k_tail.shape[1], k_tail.shape[2]
    G = H // Hkv
    off, n = int(layer_off[layer]), int(layer_rows[layer])
    kp, vp = k_pool[off:off + n].float(), v_pool[off:off + n].float()
    rh = row_head[off:off + n]
    tail_ok = attention.causal_mask(tail_len, 0, T, Tcap, q.device)
    out = torch.empty((Hkv, G, T, D), dtype=torch.float32, device=q.device)
    for h in range(Hkv):
        qh = q[:, h * G:(h + 1) * G].float().transpose(0, 1)        # (G, T, D)
        s_pool = (qh @ kp.T * scale).masked_fill((rh != h)[None, None],
                                                 attention.NEG_INF)
        s_tail = (qh @ k_tail[layer, h].float().T * scale).masked_fill(
            ~tail_ok, attention.NEG_INF)
        p = attention.softmax_guarded(torch.cat([s_pool, s_tail], dim=-1))
        out[h] = p @ torch.cat([vp, v_tail[layer, h].float()], dim=0)
    return out.permute(2, 0, 1, 3).reshape(T, H, D).to(q.dtype)


def pool_decode_attend(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, row_head: torch.Tensor,
                       layer_off: torch.Tensor, layer_rows: torch.Tensor,
                       k_tail: torch.Tensor, v_tail: torch.Tensor,
                       tail_len: int, layer: int, *, scale: float,
                       max_rows: int) -> torch.Tensor:
    """q (T, H, D); k_pool/v_pool (P, D); row_head (P,) int32 (-1 padding);
    layer_off/layer_rows (L,) int32; k_tail/v_tail (L, Hkv, Tcap, D) with
    this step's T rows already written at ``tail_len``; ``max_rows`` bounds
    every layer's live rows -> (T, H, D)."""
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
            or row_head.shape != (k_pool.shape[0],) or not 0 <= layer < L \
            or tail_len + T > Tcap:
        raise ValueError(f"pool_decode_attend: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} tail {tuple(k_tail.shape)}"
                         f" tail_len {tail_len}")
    R = (H // Hkv) * T
    ch = split_size(max_rows, -(-R // 64), target=512)
    s_pool = -(-max_rows // ch)
    out = torch.empty_like(q)
    part_acc = torch.empty((Hkv, s_pool + 1, R, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((Hkv, s_pool + 1, R, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        fn = _build.kernel("pool_decode", "kvz_pool_decode", _ARGS)
        _build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        row_head.data_ptr(), layer_off.data_ptr(),
                        layer_rows.data_ptr(), k_tail.data_ptr(),
                        v_tail.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                        part_ml.data_ptr(), T, H, Hkv, Tcap, layer, tail_len,
                        ch, s_pool, scale, stream_ptr(q.device)),
                     "pool_decode_attend")
    LAUNCHES["pool_decode_attend"] += 1
    return out
