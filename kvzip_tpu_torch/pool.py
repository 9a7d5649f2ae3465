"""POOL decode layout of the port (bf16 / float32, or int4): every layer's
kept rows in one pool.

Port of ``kvzip_tpu/pool.py`` (``PoolKV``, ``PoolInt4KV``). Layer ``l``'s kept rows sit
at pool rows ``[layer_off[l], layer_off[l] + layer_rows[l])`` in head-major
order, each row tagged with its kv head in ``row_head`` (-1 on padding).
Each segment is padded to a multiple of ``align``. Query/answer KV goes to
per-layer tails ``(L, Hkv, Tcap, D)``; ``tail_lens`` (Hkv,), ``tail_len``
(its entry 0) and ``seen`` are int32 device tensors, as in ``cache.py``
(:func:`~kvzip_tpu_torch.cache.device_counters`): snapshot and restore
stay O(1) and a decode step reads nothing back.

The port keeps K row-major ``(P, D)`` like V (the reference stores K
transposed for the TPU's matrix unit) and uses a 64-row alignment, the key
tile of the decode kernels (K3, K7), instead of the reference's
grid-step-driven 8192-65536. The int4 pool holds the dense int4 cache's
packed rows verbatim ``(P, D//2)`` with float32 per-row scales and zeros
``(P,)``; its tail stays in the model dtype and is quantized when a refold
moves it into the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from kvzip_tpu_torch.cache import Int4KVCache, KVCache, device_counters, full_keep

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
    tail_len: torch.Tensor    # () int32, tail_lens[0] (an int given)
    seen: torch.Tensor        # () int32 (an int given)
    align: int
    max_rows: int             # max over layers of round_up(live, align)

    def __post_init__(self):
        device_counters(self, self.k_tail.shape[1])  # tail_lens (Hkv,) int32

    def mem_bytes(self) -> int:
        """Bytes allocated (the reference's count): K and V pools, row_head
        and both tails."""
        ctx = ((self.k_pool.numel() + self.v_pool.numel()) * self.k_pool.element_size()
               + self.row_head.numel() * self.row_head.element_size())
        return ctx + self.k_tail.numel() * self.k_tail.element_size() * 2

    def used_bytes(self) -> float:
        rows = int(self.lengths.sum())
        return float(rows * self.k_pool.shape[1] * self.k_pool.element_size() * 2)


@dataclasses.dataclass
class PoolInt4KV:
    k_pool_q: torch.Tensor    # (P, D//2) uint8 split-packed rows
    v_pool_q: torch.Tensor
    k_pool_s: torch.Tensor    # (P,) float32 per-row scale
    k_pool_z: torch.Tensor    # (P,) float32 per-row zero
    v_pool_s: torch.Tensor
    v_pool_z: torch.Tensor
    row_head: torch.Tensor    # (P,) int32 kv head, -1 on padding
    layer_off: torch.Tensor   # (L,) int32
    layer_rows: torch.Tensor  # (L,) int32
    k_tail: torch.Tensor      # (L, Hkv, Tcap, D) model dtype
    v_tail: torch.Tensor
    lengths: torch.Tensor     # (L, Hkv) int32
    tail_len: torch.Tensor    # () int32, tail_lens[0] (an int given)
    seen: torch.Tensor        # () int32 (an int given)
    align: int
    max_rows: int

    def __post_init__(self):
        device_counters(self, self.k_tail.shape[1])  # tail_lens (Hkv,) int32

    def mem_bytes(self) -> int:
        """Bytes allocated (the reference's count): packed K and V, the four
        float32 scale and zero arrays, row_head and both tails."""
        ctx = (self.k_pool_q.numel() + self.v_pool_q.numel()
               + 4 * self.k_pool_s.numel() * self.k_pool_s.element_size()
               + self.row_head.numel() * self.row_head.element_size())
        return ctx + self.k_tail.numel() * self.k_tail.element_size() * 2

    def used_bytes(self) -> float:
        """Live context bytes: packed row plus its float32 scale and zero,
        for K and V (the reference's count)."""
        row = self.k_pool_q.shape[1] + 2 * self.k_pool_s.element_size()
        return float(int(self.lengths.sum()) * row * 2)


_INT4_FIELDS = ("k_pool_q", "v_pool_q", "k_pool_s", "k_pool_z", "v_pool_s",
                "v_pool_z")


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
    L, H, _ = keep.shape
    keep_full = full_keep(keep, sink, C)
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


def _new_pool_int4(per_layer: np.ndarray, H: int, Tcap: int, D: int, dtype,
                   device, align: int, lengths: torch.Tensor,
                   seen: int) -> PoolInt4KV:
    off, alloc, max_rows = plan_offsets(per_layer, align)
    L = len(per_layer)
    arrays = {f: torch.zeros((alloc, D // 2) if f.endswith("q") else (alloc,),
                             dtype=torch.uint8 if f.endswith("q") else torch.float32,
                             device=device) for f in _INT4_FIELDS}
    return PoolInt4KV(
        **arrays,
        row_head=torch.full((alloc,), -1, dtype=torch.int32, device=device),
        layer_off=torch.from_numpy(off).to(device),
        layer_rows=torch.from_numpy(per_layer.astype(np.int32)).to(device),
        k_tail=torch.zeros((L, H, Tcap, D), dtype=dtype, device=device),
        v_tail=torch.zeros((L, H, Tcap, D), dtype=dtype, device=device),
        lengths=lengths, tail_len=0, seen=seen, align=align, max_rows=max_rows)


def build_pool_int4_stepped(cache: Int4KVCache, keep: torch.Tensor, sink: int,
                            tail_cap: int, dtype=torch.bfloat16,
                            align: int = POOL_ALIGN) -> PoolInt4KV:
    """Compact a dense int4 cache into the int4 pool, one layer at a time:
    packed rows move verbatim (no requantization), scales and zeros become
    float32. The dense cache is left intact; the caller drops it."""
    L, H, C, Dp = cache.k_q.shape
    order, lengths = _plan(keep, sink, C)
    per_layer = lengths.sum(dim=1).cpu().numpy().astype(np.int64)
    pool = _new_pool_int4(per_layer, H, tail_cap, 2 * Dp, dtype, cache.k_q.device,
                          align, lengths, cache.seen)
    off = pool.layer_off.tolist()
    src = dict(k_pool_q=cache.k_q, v_pool_q=cache.v_q, k_pool_s=cache.k_s,
               k_pool_z=cache.k_z, v_pool_s=cache.v_s, v_pool_z=cache.v_z)
    for l in range(L):
        n, o = int(per_layer[l]), off[l]
        take = order[l, :n]
        for f, a in src.items():
            dst = getattr(pool, f)
            dst[o:o + n] = a[l].reshape(H * C, *a.shape[3:])[take].to(dst.dtype)
        pool.row_head[o:o + n] = (take // C).to(torch.int32)
    return pool


def synthetic_full_pool(num_layers: int, num_kv_heads: int, head_dim: int,
                        per_head_rows: int, tail_cap: int,
                        dtype=torch.bfloat16, device="cuda",
                        align: int = POOL_ALIGN, seen: int = 0,
                        int4: bool = False):
    """Full-occupancy pool with the geometry an all-rows-kept build gives:
    the full-cache decode baseline after the dense cache is gone. Constant
    fill (the reference's values): decode time does not depend on them."""
    L, H, D = num_layers, num_kv_heads, head_dim
    rows_l = H * per_head_rows
    per_layer = np.full((L,), rows_l, np.int64)
    lengths = torch.full((L, H), per_head_rows, dtype=torch.int32, device=device)
    if int4:
        pool = _new_pool_int4(per_layer, H, tail_cap, D, dtype, device, align,
                              lengths, seen or per_head_rows)
        pool.k_pool_q.fill_(0x5A)
        pool.v_pool_q.fill_(0xA5)
        for f in ("k_pool_s", "v_pool_s"):
            getattr(pool, f).fill_(0.01)
        for f in ("k_pool_z", "v_pool_z"):
            getattr(pool, f).fill_(-0.05)
    else:
        pool = _new_pool(per_layer, H, tail_cap, D, dtype, device, align,
                         lengths, seen or per_head_rows)
        pool.k_pool.fill_(0.02)
        pool.v_pool.fill_(0.03)
    heads = torch.arange(H, dtype=torch.int32, device=device).repeat_interleave(
        per_head_rows)
    for o in pool.layer_off.tolist():
        pool.row_head[o:o + rows_l] = heads
    return pool


def refold_pool(cache):
    """Fold the committed tail rows (query/answer KV kept by
    ``update_cache=True`` turns) into the pool, so the tail empties.

    Per layer the segment stays head-major, each head's tail rows placed
    after that head's kept rows (a stable sort by head). An int4 pool's tail
    rows are quantized (``quantize_int4``, split packing) like every other
    context row. Returns a new pool whose ``tail_len`` is 0.
    """
    from kvzip_tpu_torch.ops.quant import quantize_int4

    L, H, Tcap, D = cache.k_tail.shape
    n_tail = int(cache.tail_len)
    is_int4 = isinstance(cache, PoolInt4KV)
    rows_old = cache.layer_rows.cpu().numpy().astype(np.int64)
    per_layer = rows_old + H * n_tail
    dev = cache.row_head.device
    args = (per_layer, H, Tcap, D, cache.k_tail.dtype, dev, cache.align,
            cache.lengths + n_tail, cache.seen)
    new = _new_pool_int4(*args) if is_int4 else _new_pool(*args)
    if is_int4:
        kt = quantize_int4(cache.k_tail[:, :, :n_tail], pack="split")
        vt = quantize_int4(cache.v_tail[:, :, :n_tail], pack="split")
        # (L, H, n_tail, ...) tail rows per pool field
        tails = dict(zip(("k_pool_q", "k_pool_s", "k_pool_z"), kt))
        tails.update(zip(("v_pool_q", "v_pool_s", "v_pool_z"), vt))
        tails = {f: a.reshape(L, H * n_tail, *a.shape[3:])
                 if a.shape[-1] > 1 else a.reshape(L, H * n_tail)
                 for f, a in tails.items()}
        fields = _INT4_FIELDS
    else:
        tails = {"k_pool": cache.k_tail[:, :, :n_tail].reshape(L, H * n_tail, D),
                 "v_pool": cache.v_tail[:, :, :n_tail].reshape(L, H * n_tail, D)}
        fields = ("k_pool", "v_pool")
    off_old = cache.layer_off.tolist()
    off_new = new.layer_off.tolist()
    t_head = torch.arange(H, dtype=torch.int32, device=dev).repeat_interleave(n_tail)
    for l in range(L):
        o, n = off_old[l], int(rows_old[l])
        rh = torch.cat([cache.row_head[o:o + n], t_head])
        # padding rows (-1) inside the live range sort to the segment end
        key = torch.where(rh >= 0, rh, torch.full_like(rh, H))
        m = int(per_layer[l])
        idx = torch.sort(key, stable=True).indices[:m]
        on = off_new[l]
        for f in fields:
            dst = getattr(new, f)
            src = torch.cat([getattr(cache, f)[o:o + n], tails[f][l].to(dst.dtype)])
            dst[on:on + m] = src[idx]
        new.row_head[on:on + m] = rh[idx]
    return new
