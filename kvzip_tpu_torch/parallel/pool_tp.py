"""Tensor-parallel POOL decode: each rank's pool over its local kv heads.

Port of ``kvzip_tpu/parallel/pool_tp.py``. Eviction and compaction are
local to a head once KV is head-sharded, so each "model" rank gets its own
pool over its ``Hkv/tp`` heads, and attention runs the single-device
kernels (K3 on a bf16 pool, K7 on an int4 one, also in its ``q8`` mode) on
the rank's query heads: no collective inside attention; the all-reduce
after the row-parallel ``wo`` is the only cross-rank step, as on the dense
TP path. The reference's ``pool_attend_tp`` (a ``shard_map`` around the
kernel) has no function of its own here: a rank's pool is an ordinary
pool, so the forward's pool branch (``models/transformer.py``) is that
local K3/K7 call.

The reference is one SPMD program, so its per-shard pools share one array:
every shard's segment is padded to the largest shard's allocation, and the
layer offsets become ``(tp, L)``. One rank's pool here is an ordinary
single-device pool (its own offsets, rows and allocation), so none of that
padding exists; what matches the reference is the outputs: the same kept
rows a head, the same attention, logits and tokens. The pool carries
``tp`` and the mesh, so that the guards fire as the reference's do: a TP
pool's tail refold raises (``Engine._maybe_refold``), ``save_state``
refuses it, and serving's merged pool refuses it.
"""

from __future__ import annotations

import torch

from kvzip_tpu_torch.cache import Int4KVCache, KVCache
from kvzip_tpu_torch.parallel.mesh import axis_size
from kvzip_tpu_torch.pool import POOL_ALIGN, build_pool_int4_stepped, build_pool_stepped


def build_pool_tp(cache, keep: torch.Tensor, sink: int, tail_cap: int, dtype,
                  align: int = POOL_ALIGN, mesh=None):
    """The rank's pool from its head-sharded dense cache (bf16 or int4) and
    its local keep mask (L, Hkv/tp, ctx), built layer by layer as the
    single-device builders build theirs; ``row_head`` holds local head ids,
    which the kernels match against the local query heads."""
    if isinstance(cache, Int4KVCache):
        pool = build_pool_int4_stepped(cache, keep, sink, tail_cap, dtype, align=align)
    elif isinstance(cache, KVCache):
        pool = build_pool_stepped(cache, keep, sink, tail_cap, align=align)
    else:
        raise TypeError(f"a TP pool is built from a dense cache, not {type(cache).__name__}")
    pool.tp = axis_size(mesh, "model")
    pool.mesh = mesh
    return pool
