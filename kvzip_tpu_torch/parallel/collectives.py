"""The sharded forward's collectives on the mesh's "model" sub-group.

What XLA's GSPMD inserts for the reference, written out: an all-reduce
after each row-parallel product (``wo``, ``w_down``), a masked local
lookup plus an all-reduce for the vocabulary-split embedding, local
logits plus an all-gather for the vocabulary-split head, and for W8A8 the
all-reduce(MAX) of the local maxima of a row-parallel activation, so
that its int8 bytes and scale are those of the whole row (the reference
quantizes with the maximum over its whole row, ``ops/quant.py``).

Every call adds one to ``ops.COLLECTIVES[<name>]``, so a captured decode
step counts its collectives the way it counts its kernels. Nothing here
reads the device back: these calls run inside a captured step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kvzip_tpu_torch import ops
from kvzip_tpu_torch.ops.quant import EPS
from kvzip_tpu_torch.parallel.mesh import Shard, shard_of


def _count(name: str) -> None:
    ops.COLLECTIVES[name] = ops.COLLECTIVES.get(name, 0) + 1


def all_reduce(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM, axis: str = "model"
               ) -> torch.Tensor:
    """``x`` summed (or ``op``) over a mesh axis, in place; returns it."""
    dist.all_reduce(x, op=op, group=mesh.get_group(axis))
    _count(f"all_reduce {axis}")
    return x


def all_gather(x: torch.Tensor, mesh, dim: int, axis: str = "model") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in their axis order."""
    g = mesh.get_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.contiguous(), group=g)
    _count(f"all_gather {axis}")
    return torch.cat(parts, dim=dim)


def embed(emb, ids: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """Rows of a vocabulary-split embedding: each rank looks up the ids of
    its rows [v0, v1), zeros the others, and the ranks' rows are summed."""
    from kvzip_tpu_torch.ops.quant import embed_lookup

    sh = shard_of(cfg, mesh)
    mine = (ids >= sh.v0) & (ids < sh.v1)
    local = torch.where(mine, ids - sh.v0, torch.zeros_like(ids))
    x = embed_lookup(emb, local)
    x = torch.where(mine[:, None], x, torch.zeros_like(x))
    return all_reduce(x, mesh)


def logits(head, xf: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """Logits over the whole vocabulary: a vocabulary-split head's local
    columns, padded with -inf to the split's chunk, gathered over "model";
    a replicated (W4A8) head's own."""
    from kvzip_tpu_torch.ops.quant import head_logits

    y = head_logits(head, xf)
    if isinstance(head, dict) and "q4" in head:
        return y
    sh = shard_of(cfg, mesh)
    if y.shape[-1] < sh.v_chunk:
        pad = y.new_full((*y.shape[:-1], sh.v_chunk - y.shape[-1]), float("-inf"))
        y = torch.cat([y, pad], dim=-1)
    return all_gather(y, mesh, dim=-1)[..., :sh.V]


def quantize_act_int8(x: torch.Tensor, mesh):
    """Per-token int8 of a row split over "model" (a row-parallel input):
    the scale from the maximum over the WHOLE row (the local maxima's
    all-reduce MAX), so the local bytes are the slice of the
    single-device quantization's."""
    xf = x.float()
    amax = all_reduce(xf.abs().amax(dim=-1, keepdim=True), mesh, op=dist.ReduceOp.MAX)
    xs = amax / 127.0 + EPS
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def silu_mul_quant(gate: torch.Tensor, up: torch.Tensor, act: str, sh: Shard, mesh):
    """K14 under a mesh: gate and up (T, I/tp) gathered to the whole row,
    one K14 call over it (its maximum is the row's), the rank's slice of
    its int8 output kept with the row's scale."""
    from kvzip_tpu_torch.ops.fused_act import silu_mul_quant as k14

    full = all_gather(torch.cat([gate, up], dim=-1).contiguous(), mesh, dim=-1)
    I = gate.shape[-1]
    parts = full.view(*full.shape[:-1], sh.tp, 2, I)
    g_full = parts[..., 0, :].reshape(*full.shape[:-1], sh.tp * I)
    u_full = parts[..., 1, :].reshape(*full.shape[:-1], sh.tp * I)
    hq, hs = k14(g_full.contiguous(), u_full.contiguous(), act=act)
    return hq[..., sh.i0:sh.i0 + I].contiguous(), hs


def merge_replica_scores(scores: torch.Tensor, sh: Shard, mesh) -> torch.Tensor:
    """Scores (L, 1, W) of a kv head that ``sh.rep`` ranks share, each from
    its own query heads: the maximum over them (KVzip's score is the
    maximum over a kv head's query heads). A no-op where no rank shares
    its kv heads."""
    if sh.rep == 1:
        return scores
    full = scores.new_zeros((scores.shape[0], sh.Hkv_full, scores.shape[-1]))
    full[:, sh.kv0] = scores[:, 0]
    all_reduce(full, mesh, op=dist.ReduceOp.MAX)
    return full[:, sh.kv0:sh.kv0 + 1].contiguous()


class ScoreGroup:
    """The prune's reductions over the "model" ranks (``prune.py``'s
    ``group``): sums, minima and maxima of every rank's value, and the
    whole (L, Hkv, ctx) scores gathered. A kv head shared by several
    ranks counts once: only its first rank has ``weight`` 1."""

    def __init__(self, mesh, sh: Shard):
        self.mesh, self.sh = mesh, sh
        self.weight = 1 if sh.rep_idx == 0 else 0

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.reshape(-1).clone()  # a 0-dim value as one element
        all_reduce(out, self.mesh, op=op)
        return out.reshape(t.shape)

    def sum(self, t):
        return self._reduce(t, dist.ReduceOp.SUM)

    def min(self, t):
        return self._reduce(t, dist.ReduceOp.MIN)

    def max(self, t):
        return self._reduce(t, dist.ReduceOp.MAX)

    def gather(self, score: torch.Tensor) -> torch.Tensor:
        full = all_gather(score, self.mesh, dim=1)
        return full[:, ::self.sh.rep] if self.sh.rep > 1 else full
