"""POOL decode layout of the port (bf16 / float32): every layer's kept rows
in one pool.

Port of the bf16 part of ``kvzip_tpu/pool.py``. Layer ``l``'s kept rows sit
at pool rows ``[layer_off[l], layer_off[l] + layer_rows[l])`` in head-major
order, each row tagged with its kv head in ``row_head`` (-1 on padding).
Each segment is padded to a multiple of ``align``. Query/answer KV goes to
per-layer tails ``(L, Hkv, Tcap, D)``; ``tail_len`` and ``seen`` are host
ints, so snapshot and restore stay O(1).

The port keeps K row-major ``(P, D)`` like V (the reference stores K
transposed for the TPU's matrix unit) and uses a 64-row alignment, the key
tile of the decode kernel (K3), instead of the reference's grid-step-driven
8192-65536.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from kvzip_tpu_torch.cache import KVCache

POOL_ALIGN = 64


@dataclasses.dataclass
class PoolKV:
    k_pool: torch.Tensor      # (P, D)
    v_pool: torch.Tensor      # (P, D)
    row_head: torch.Tensor    # (P,) int32 kv head, -1 on padding
    layer_off: torch.Tensor   # (L,) int32 row offset (multiple of align)
    layer_rows: torch.Tensor  # (L,) int32 live rows
    k_tail: torch.Tensor      # (L, Hkv, Tcap, D)
    v_tail: torch.Tensor
    lengths: torch.Tensor     # (L, Hkv) int32 kept context rows
    tail_len: int
    seen: int
    align: int
    max_rows: int             # max over layers of round_up(live, align)

    def used_bytes(self) -> float:
        rows = int(self.lengths.sum())
        return float(rows * self.k_pool.shape[1] * self.k_pool.element_size() * 2)


def _round_up_arr(a: np.ndarray, m: int) -> np.ndarray:
    return ((a + m - 1) // m) * m


def plan_offsets(per_layer_rows: np.ndarray, align: int
                 ) -> Tuple[np.ndarray, int, int]:
    """Host-side pool geometry from per-layer live row counts: (layer_off,
    allocated rows, max_rows). Every segment is padded to an ``align``
    multiple, at least one ``align`` even for an empty layer."""
    r_pad = np.maximum(align, _round_up_arr(np.asarray(per_layer_rows), align))
    off = np.zeros_like(r_pad)
    off[1:] = np.cumsum(r_pad)[:-1]
    return off.astype(np.int32), int(off[-1] + r_pad[-1]), int(r_pad.max())


def _plan(keep: torch.Tensor, sink: int, C: int):
    """Gather plan: for each layer, the kept (head * C + row) indices of the
    dense cache in head-major order (sink rows always kept), and the kept
    rows per (layer, head)."""
    L, H, ctx_len = keep.shape
    keep_full = torch.zeros((L, H, C), dtype=torch.bool, device=keep.device)
    keep_full[:, :, :sink] = True
    keep_full[:, :, sink:sink + ctx_len] = keep.bool()
    flat = keep_full.reshape(L, H * C)
    order = torch.sort((~flat).to(torch.uint8), dim=1, stable=True).indices
    lengths = keep_full.sum(dim=-1).to(torch.int32)
    return order, lengths


def _new_pool(per_layer: np.ndarray, H: int, Tcap: int, D: int, dtype, device,
              align: int, lengths: torch.Tensor, seen: int) -> PoolKV:
    off, alloc, max_rows = plan_offsets(per_layer, align)
    L = len(per_layer)
    return PoolKV(
        k_pool=torch.zeros((alloc, D), dtype=dtype, device=device),
        v_pool=torch.zeros((alloc, D), dtype=dtype, device=device),
        row_head=torch.full((alloc,), -1, dtype=torch.int32, device=device),
        layer_off=torch.from_numpy(off).to(device),
        layer_rows=torch.from_numpy(per_layer.astype(np.int32)).to(device),
        k_tail=torch.zeros((L, H, Tcap, D), dtype=dtype, device=device),
        v_tail=torch.zeros((L, H, Tcap, D), dtype=dtype, device=device),
        lengths=lengths, tail_len=0, seen=seen, align=align, max_rows=max_rows)


def build_pool_stepped(cache: KVCache, keep: torch.Tensor, sink: int,
                       tail_cap: int, align: int = POOL_ALIGN) -> PoolKV:
    """Compact a dense cache into the pool, one layer at a time (peak: the
    dense cache + the pool + one layer's gather). The dense cache is left
    intact; the caller drops it."""
    L, H, C, D = cache.k.shape
    order, lengths = _plan(keep, sink, C)
    per_layer = lengths.sum(dim=1).cpu().numpy().astype(np.int64)
    pool = _new_pool(per_layer, H, tail_cap, D, cache.k.dtype, cache.k.device,
                     align, lengths, cache.seen)
    off = pool.layer_off.tolist()
    for l in range(L):
        n, o = int(per_layer[l]), off[l]
        take = order[l, :n]
        pool.k_pool[o:o + n] = cache.k[l].reshape(H * C, D)[take]
        pool.v_pool[o:o + n] = cache.v[l].reshape(H * C, D)[take]
        pool.row_head[o:o + n] = (take // C).to(torch.int32)
    return pool


def synthetic_full_pool(num_layers: int, num_kv_heads: int, head_dim: int,
                        per_head_rows: int, tail_cap: int,
                        dtype=torch.bfloat16, device="cuda",
                        align: int = POOL_ALIGN, seen: int = 0) -> PoolKV:
    """Full-occupancy pool with the geometry an all-rows-kept build gives:
    the full-cache decode baseline after the dense cache is gone. Constant
    fill: decode time does not depend on the values."""
    L, H, D = num_layers, num_kv_heads, head_dim
    rows_l = H * per_head_rows
    per_layer = np.full((L,), rows_l, np.int64)
    lengths = torch.full((L, H), per_head_rows, dtype=torch.int32, device=device)
    pool = _new_pool(per_layer, H, tail_cap, D, dtype, device, align, lengths,
                     seen or per_head_rows)
    pool.k_pool.fill_(0.02)
    pool.v_pool.fill_(0.03)
    heads = torch.arange(H, dtype=torch.int32, device=device).repeat_interleave(
        per_head_rows)
    for o in pool.layer_off.tolist():
        pool.row_head[o:o + rows_l] = heads
    return pool


def refold_pool(cache: PoolKV) -> PoolKV:
    """Fold the committed tail rows (query/answer KV kept by
    ``update_cache=True`` turns) into the pool, so the tail empties.

    Per layer the segment stays head-major, each head's tail rows placed
    after that head's kept rows (a stable sort by head). Returns a new pool
    whose ``tail_len`` is 0.
    """
    L, H, Tcap, D = cache.k_tail.shape
    n_tail = cache.tail_len
    rows_old = cache.layer_rows.cpu().numpy().astype(np.int64)
    per_layer = rows_old + H * n_tail
    new = _new_pool(per_layer, H, Tcap, D, cache.k_pool.dtype,
                    cache.k_pool.device, cache.align,
                    cache.lengths + n_tail, cache.seen)
    off_old = cache.layer_off.tolist()
    off_new = new.layer_off.tolist()
    dev = cache.k_pool.device
    t_head = torch.arange(H, dtype=torch.int32, device=dev).repeat_interleave(n_tail)
    for l in range(L):
        o, n = off_old[l], int(rows_old[l])
        rh = torch.cat([cache.row_head[o:o + n], t_head])
        # padding rows (-1) inside the live range sort to the segment end
        key = torch.where(rh >= 0, rh, torch.full_like(rh, H))
        idx = torch.sort(key, stable=True).indices
        m = int(per_layer[l])
        idx = idx[:m]
        k_src = torch.cat([cache.k_pool[o:o + n],
                           cache.k_tail[l, :, :n_tail].reshape(H * n_tail, D)])
        v_src = torch.cat([cache.v_pool[o:o + n],
                           cache.v_tail[l, :, :n_tail].reshape(H * n_tail, D)])
        on = off_new[l]
        new.k_pool[on:on + m] = k_src[idx]
        new.v_pool[on:on + m] = v_src[idx]
        new.row_head[on:on + m] = rh[idx]
    return new
