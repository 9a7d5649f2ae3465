"""Sequence-parallel (ring attention) prefill over the mesh "data" axis.

Port of ``kvzip_tpu/parallel/ring_prefill.py``. The context tokens are
split into ``n`` equal slabs over the "data" ranks (slab s holds positions
[s*S, (s+1)*S)); each rank projects Q/K/V for its slab on its "model"
shard's heads, and the K/V slabs rotate around the ring
(``torch.distributed.batch_isend_irecv`` on the "data" group, ``n - 1``
times) while every rank accumulates the online-softmax attention of its
local queries against the visiting slab, masked by ABSOLUTE positions
(a slab wholly in a rank's future is skipped). After the ``n`` hops every
query row has seen every row at or before it: single-device causal
attention up to the float32 accumulation order. The layer's other
collectives are ``forward``'s (``parallel/collectives.py``, on "model").

The reference builds a hop's whole ``(S, Hkv, G, S)`` float32 score block;
the port takes the local queries in blocks (``BLOCK_BYTES`` of scores at a
time) with the same arithmetic. It is the port of an XLA route: torch ops,
not a kernel. :func:`reshard_to_cache` then turns the sequence-split KV
into the engine's head-sharded cache with one all-gather over "data".
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from kvzip_tpu_torch.config import ModelConfig
from kvzip_tpu_torch.parallel.mesh import axis_size, shard_of

BLOCK_BYTES = 1 << 29  # float32 scores of one block of local queries


def _rotate(tensors, group) -> list:
    """Each tensor sent to the next rank of the group's ring, the previous
    rank's received in its place."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _ring_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int, scale: float,
                 group) -> torch.Tensor:
    """Exact causal attention of the local queries q (S, H, D) at positions
    [q0, q0 + S) over every rank's K/V slab (S, Hkv, D), the slabs
    rotating around ``group``'s ring. Returns (S, H, D) in q's dtype."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    S, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qf = q.float().reshape(S, Hkv, G, D)
    m = torch.full((S, Hkv, G), float("-inf"), device=q.device)
    l = torch.zeros((S, Hkv, G), device=q.device)
    acc = torch.zeros((S, Hkv, G, D), device=q.device)
    pos_q = q0 + torch.arange(S, device=q.device)
    block = max(1, BLOCK_BYTES // (H * S * 4))
    k_vis, v_vis = k, v
    for hop in range(n):
        origin = (me - hop) % n            # the rank whose slab is visiting
        if origin <= me:                   # a later slab is all in the future
            kf, vf = k_vis.float(), v_vis.float()
            pos_k = origin * S + torch.arange(S, device=q.device)
            for b0 in range(0, S, block):
                b1 = min(S, b0 + block)
                s = torch.einsum("qhgd,khd->qhgk", qf[b0:b1], kf) * scale
                causal = pos_k[None, :] <= pos_q[b0:b1, None]
                s = s.masked_fill(~causal[:, None, None, :], float("-inf"))
                m_new = torch.maximum(m[b0:b1], s.amax(dim=-1))
                alpha = torch.where(torch.isfinite(m[b0:b1]), torch.exp(m[b0:b1] - m_new),
                                    torch.zeros_like(m_new))
                p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]),
                                torch.zeros_like(s))
                l[b0:b1] = l[b0:b1] * alpha + p.sum(dim=-1)
                acc[b0:b1] = acc[b0:b1] * alpha[..., None] + torch.einsum(
                    "qhgk,khd->qhgd", p, vf)
                m[b0:b1] = m_new
        if hop < n - 1:
            k_vis, v_vis = _rotate([k_vis, v_vis], group)
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.reshape(S, H, D).to(q.dtype)


def ring_prefill(params, cfg: ModelConfig, ids, mesh, *, axis: str = "data"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel prefill of ``ids`` ((T,) token ids, the same on
    every rank, T divisible by the axis size) with the rank's shard of the
    weights (``shard_params``; unfused projections: plain, W8A8, or a
    replicated v1 W4A8 tree). Returns
    the rank's (k, v): its slab of the sequence on its kv heads, (L,
    Hkv/tp, T/n, D) each, sequence-split over ``axis`` (pass them to
    :func:`reshard_to_cache`)."""
    from kvzip_tpu_torch.models.rope import apply_rope, rope_cos_sin
    from kvzip_tpu_torch.models.transformer import (_act, _down, _is_w4, _lin_rows, _lin_shared,
                                                    _local_heads, embed, post_norm, qk_norm,
                                                    rms_norm)

    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    ids = torch.as_tensor(ids)
    T = ids.shape[0]
    if T % n:
        raise ValueError(f"token count {T} not divisible by {axis}={n}")
    lp_all = params["layers"]
    if "wq" not in lp_all:
        raise ValueError("ring prefill takes unfused projections (wq, wk, wv)")
    sh = shard_of(cfg, mesh)
    L, H, Hkv, Dh = cfg.num_layers, sh.H, sh.Hkv, cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    eps, gemma = cfg.rms_norm_eps, cfg.gemma_style_norm
    S = T // n
    q0 = dist.get_rank(group) * S
    dev = lp_all["ln_attn"].device
    ids_local = ids[q0:q0 + S].to(device=dev, dtype=torch.int64)
    x = embed(params, cfg, ids_local, mesh)
    cos, sin = rope_cos_sin(cfg.rope, Dh, q0 + torch.arange(S, device=dev))
    ks, vs = [], []
    for l in range(L):
        lp = {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict) else v[l])
              for k, v in lp_all.items()}
        q, k, v = _lin_shared(rms_norm(x, lp["ln_attn"], eps, gemma),
                              (lp["wq"], lp["wk"], lp["wv"]),
                              (lp.get("bq"), lp.get("bk"), lp.get("bv")))
        if _is_w4(lp["wq"]):
            q, k, v = _local_heads(q, k, v, sh, Dh)  # a replicated W4A8 weight
        q, k = qk_norm(cfg, lp, q.reshape(S, H, Dh), k.reshape(S, Hkv, Dh))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        v = v.reshape(S, Hkv, Dh)
        attn = _ring_attend(q, k, v, q0, scale, group)
        o = _lin_rows(attn.reshape(S, H * Dh), lp["wo"], mesh)
        x = x + post_norm(cfg, lp, "ln_post_attn", o)
        gate, up = _lin_shared(rms_norm(x, lp["ln_mlp"], eps, gemma),
                               (lp["w_gate"], lp["w_up"]), (None, None))
        mlp = _down(_act(gate, cfg.hidden_act) * up, lp["w_down"], mesh)
        x = x + post_norm(cfg, lp, "ln_post_mlp", mlp)
        ks.append(k.transpose(0, 1))
        vs.append(v.transpose(0, 1))
    return torch.stack(ks), torch.stack(vs)


def reshard_to_cache(k: torch.Tensor, v: torch.Tensor, mesh, cache, *, axis: str = "data"):
    """Place the ring's sequence-split KV (the rank's slab (L, Hkv/tp, S,
    D)) into the rank's head-sharded dense cache: one all-gather over
    ``axis`` gives every row of its kv heads, written at rows [0, T);
    ``lengths`` and ``seen`` become T (in place). Returns the cache."""
    from kvzip_tpu_torch.parallel import collectives as tpc

    if axis_size(mesh, axis) > 1:
        k = tpc.all_gather(k, mesh, dim=2, axis=axis)
        v = tpc.all_gather(v, mesh, dim=2, axis=axis)
    T = k.shape[2]
    if T > cache.capacity:
        raise ValueError(f"{T} ring rows exceed the cache's capacity {cache.capacity}")
    cache.k[:, :, :T] = k.to(cache.k.dtype)
    cache.v[:, :, :T] = v.to(cache.v.dtype)
    cache.lengths.fill_(T)
    cache.seen.fill_(T)
    return cache
