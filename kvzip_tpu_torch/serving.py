"""Batched serving of the port: decode many compressed contexts at once.

Port of ``kvzip_tpu/serving.py``. B states, each prefilled, scored and
pruned on its own (possibly at different ratios), MERGE into one pool
(:func:`_merge_pool`) or one legacy flat cache (:func:`_merge_flat`) whose
kv-head space is B·Hkv: each request's rows keep their kv head h as
``b·Hkv + h`` in ``row_head``, so with the query heads ordered
sequence-major the decode kernels' head mapping isolates the sequences
with no extra machinery. One step of the merged layer stack
(:func:`_stack_forward`) reads the weights once and launches one attention
kernel a layer for the whole batch: K3 (bf16 pool), K7 or K7-q8 (int4
pool), K10 (bf16 flat, ``n_seq = B``), K11 or K11-q8 (int4 flat). Each
sequence's positions ride a ``(B,)`` vector (``seen``) and its tail lengths
a ``(B·Hkv,)`` vector (``tail_lens``); a token's K/V rows are appended at
its own heads' offsets (``cache.append_layer``).

The merged stack runs the linears unfused, as the reference's does
(``_lin``, ``_lin_shared``, ``w4a8_linear_stacked``: K8 on v2 W4A8 stacks
at T = B rows, K15 on a fused v1 tree): it runs no K12 whatever
``engine.fuse_layer`` says and no K13/K14 whatever ``cfg.fused_act`` says.
An unfused W4A8 tree (``wq`` among the stacks) has no path in the
reference's merged stack either and raises ``NotImplementedError``.

The greedy loop is one :class:`MergedDecodeStep` for the whole batch, built
like ``engine.DecodeStep``: no host read inside a step, captured once as a
CUDA graph on the card and replayed, the host reading the token buffer
every ``DECODE_CHUNK`` steps; on the CPU the same step runs eagerly. The
merged cache is a copy: after the loop each state gets its grown tail and
counters back IN PLACE (``copy_`` into its own tensors, which its own
captured ``DecodeStep`` reads by address).

Dense states (a retain state, pruned or not, or one compacted with
``flat_decode="off"``; the reference's dense batch path) are concatenated
on the kv-head axis into one dense cache over B·Hkv heads
(:func:`_merge_dense`: each state's rows padded to the largest capacity,
its ``valid`` mask beside them) and go through the same merged
stack and the same captured step; their attention is the masked route
``ops.attention.attend_blockwise`` over the B·Hkv heads (the reference's
``blockwise``), each query row appended at its own heads' lengths. Dense
int4 states have no batch path, as in the reference. Nothing falls back
to B single generates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from kvzip_tpu_torch.cache import FLAT_INT4_FIELDS, FlatInt4KV, FlatKV, KVCache, append_layer
from kvzip_tpu_torch.engine import DECODE_CHUNK, CapturedStep, Engine, KVState, _round_up
from kvzip_tpu_torch.models.rope import apply_rope, rope_cos_sin
from kvzip_tpu_torch.models.transformer import _act, _is_w4, _lin, _lin_shared, rms_norm
from kvzip_tpu_torch.ops.attention import attend_blockwise
from kvzip_tpu_torch.ops.flat_decode import flat_decode_attend, flat_decode_attend_int4
from kvzip_tpu_torch.ops.pool_decode import pool_decode_attend, pool_decode_attend_int4
from kvzip_tpu_torch.ops.quant import embed_lookup, head_logits
from kvzip_tpu_torch.ops.w4a8 import w4a8_linear_stacked
from kvzip_tpu_torch.pool import _INT4_FIELDS as POOL_INT4_FIELDS
from kvzip_tpu_torch.pool import PoolInt4KV, PoolKV, plan_offsets

_MERGEABLE = (FlatKV, FlatInt4KV, PoolKV, PoolInt4KV)


def _raw(cls, fields: dict):
    """A cache dataclass holding ``fields`` as given, without
    ``__post_init__`` (a merged cache's counters are vectors)."""
    obj = object.__new__(cls)
    for k, v in fields.items():
        setattr(obj, k, v)
    return obj


# ---------------------------------------------------------- merged caches
def _merge_dense(caches: Sequence):
    """B dense bf16 caches as one over B·Hkv kv heads (request b's head h
    at ``b·Hkv + h``), each padded to the largest capacity (padding rows
    are past every head's length, ``valid`` True there as in the
    reference's ``_pad_capacity``): ``lengths`` (L, B·Hkv), ``valid`` (L,
    B·Hkv, C) and ``seen`` (B,)."""
    cap = max(c.capacity for c in caches)

    def cat(f: str, fill) -> torch.Tensor:
        parts = []
        for c in caches:
            a = getattr(c, f)
            parts.append(a if a.shape[2] == cap else torch.cat(
                [a, a.new_full((*a.shape[:2], cap - a.shape[2], *a.shape[3:]), fill)], dim=2))
        return torch.cat(parts, dim=1)

    return _raw(KVCache, dict(k=cat("k", 0), v=cat("v", 0), valid=cat("valid", True),
                              lengths=torch.cat([c.lengths for c in caches], dim=1),
                              seen=torch.stack([c.seen.reshape(()) for c in caches])))


def _advance(m, n: torch.Tensor) -> None:
    """Advance the merged cache's counters by n (B,) rows a sequence: every
    head's length (a dense cache) or tail length, and the positions."""
    B = n.shape[0]
    if isinstance(m, KVCache):
        m.lengths += n.repeat_interleave(m.lengths.shape[1] // B)
    else:
        m.tail_lens += n.repeat_interleave(m.tail_lens.shape[0] // B)
    m.seen += n


def _check_mergeable(caches: Sequence) -> None:
    """One engine's caches agree on kind, layers, kv heads and tail
    capacity; a mixed batch would otherwise fail deep inside a concatenate
    (the reference's check)."""
    c0 = caches[0]
    want = (type(c0).__name__, c0.k_tail.shape[0], c0.k_tail.shape[1], c0.k_tail.shape[2])
    for b, c in enumerate(caches):
        got = (type(c).__name__, c.k_tail.shape[0], c.k_tail.shape[1], c.k_tail.shape[2])
        if got != want:
            raise ValueError(
                f"merge: request {b} cache (kind/L/Hkv/tail_cap)={got} does not match "
                f"request 0 {want}; batch requests must come from the same engine "
                "configuration")


def _merged_counters(caches: Sequence) -> dict:
    """Tails concatenated on the head axis (L, B·Hkv, Tcap, D), their
    lengths (B·Hkv,) and the sequences' positions (B,), int32 on the
    device."""
    lens = torch.cat([c.tail_lens for c in caches])
    return dict(k_tail=torch.cat([c.k_tail for c in caches], dim=1),
                v_tail=torch.cat([c.v_tail for c in caches], dim=1),
                lengths=torch.cat([c.lengths for c in caches], dim=1),
                tail_lens=lens, tail_len=lens[0],
                seen=torch.stack([c.seen.reshape(()) for c in caches]))


def _merge_flat(caches: Sequence):
    """B flat caches as one flat cache of ``n_seq = B`` equal segments
    (every cache padded to the largest ``R_pad``), kv heads ``b·Hkv + h``;
    ``seg_rows`` (L, B) each segment's live rows, where K10/K11 stop."""
    _check_mergeable(caches)
    cap = max(c.capacity for c in caches)
    Hkv = caches[0].k_tail.shape[1]
    names = FLAT_INT4_FIELDS if isinstance(caches[0], FlatInt4KV) else ("k_flat", "v_flat")
    out = {}
    for f in (*names, "row_head"):
        src = [getattr(c, f) for c in caches]
        a = torch.full((src[0].shape[0], len(caches) * cap, *src[0].shape[2:]),
                       -1 if f == "row_head" else 0, dtype=src[0].dtype, device=src[0].device)
        for b, s in enumerate(src):
            if f == "row_head":
                s = torch.where(s >= 0, s + b * Hkv, s)
            a[:, b * cap:b * cap + s.shape[1]] = s
        out[f] = a
    out["seg_rows"] = torch.cat([c.seg_rows for c in caches], dim=1)
    return _raw(type(caches[0]), {**out, **_merged_counters(caches)})


def _merge_plan(rows: np.ndarray, offs: np.ndarray, new_off: np.ndarray):
    """Host plan of the merged pool: for each request b, (dst, src) row
    indices, its live rows of every layer placed back to back after the
    earlier requests' in the merged layer segment."""
    plan = []
    before = np.zeros_like(rows[0])
    for r, o in zip(rows, offs):
        starts = np.cumsum(r) - r
        within = np.arange(int(r.sum())) - np.repeat(starts, r)
        plan.append((np.repeat(new_off + before, r) + within, np.repeat(o, r) + within))
        before = before + r
    return plan


def _merge_pool(caches: Sequence):
    """Merge B pool caches into one pool whose kv-head space is B·Hkv.

    The merged segment of layer l holds every request's live layer-l rows
    back to back (no padding between requests); only layer starts are
    aligned, to the largest ``align`` of the batch, and ``max_rows`` is the
    largest aligned segment. K, V (row-major here, where the reference
    gathers its transposed K by columns), scales and zeros are gathered by
    rows on the device from one host plan."""
    _check_mergeable(caches)
    dev = caches[0].row_head.device
    Hkv = caches[0].k_tail.shape[1]
    align = max(c.align for c in caches)
    rows = np.stack([c.layer_rows.cpu().numpy() for c in caches]).astype(np.int64)  # (B, L)
    offs = np.stack([c.layer_off.cpu().numpy() for c in caches]).astype(np.int64)
    new_off, alloc, max_rows = plan_offsets(rows.sum(0), align)
    names = POOL_INT4_FIELDS if isinstance(caches[0], PoolInt4KV) else ("k_pool", "v_pool")
    out = {f: getattr(caches[0], f).new_zeros((alloc, *getattr(caches[0], f).shape[1:]))
           for f in names}
    out["row_head"] = torch.full((alloc,), -1, dtype=torch.int32, device=dev)
    for b, (c, (dst, src)) in enumerate(zip(caches, _merge_plan(rows, offs, new_off))):
        dst = torch.from_numpy(dst).to(dev)
        src = torch.from_numpy(src).to(dev)
        for f in names:
            out[f][dst] = getattr(c, f)[src]
        rh = c.row_head[src]
        out["row_head"][dst] = torch.where(rh >= 0, rh + b * Hkv, rh)
    out.update(layer_off=torch.from_numpy(new_off).to(dev),
               layer_rows=torch.from_numpy(rows.sum(0).astype(np.int32)).to(dev),
               align=align, max_rows=max_rows)
    return _raw(type(caches[0]), {**out, **_merged_counters(caches)})


# ------------------------------------------------------ merged layer stack
def _attend(m, q: torch.Tensor, layer: int, scale: float, q8: bool, B: int) -> torch.Tensor:
    """One layer's attention of q (T, B·H, D) over the merged cache."""
    if isinstance(m, KVCache):
        return attend_blockwise(q, m.k[layer], m.v[layer], m.lengths[layer], m.valid[layer],
                                scale=scale)
    if isinstance(m, (PoolKV, PoolInt4KV)):
        meta = (m.row_head, m.layer_off, m.layer_rows, m.k_tail, m.v_tail, m.tail_lens, layer)
        if isinstance(m, PoolInt4KV):
            return pool_decode_attend_int4(q, *(getattr(m, f) for f in (
                "k_pool_q", "k_pool_s", "k_pool_z", "v_pool_q", "v_pool_s", "v_pool_z")),
                *meta, scale=scale, max_rows=m.max_rows, q8=q8, check_tail=False)
        return pool_decode_attend(q, m.k_pool, m.v_pool, *meta, scale=scale,
                                  max_rows=m.max_rows, check_tail=False)
    tail = (m.row_head, m.k_tail[layer], m.v_tail[layer], m.tail_lens)
    if isinstance(m, FlatInt4KV):
        return flat_decode_attend_int4(
            q, m.k_flat_q, m.k_flat_s, m.k_flat_z, m.v_flat_q, m.v_flat_s, m.v_flat_z, *tail,
            scale=scale, q8=q8, n_seq=B, layer=layer, seg_rows=m.seg_rows, check_tail=False)
    return flat_decode_attend(q, m.k_flat, m.v_flat, *tail, scale=scale, n_seq=B,
                              layer=layer, seg_rows=m.seg_rows, check_tail=False)


def _stack_forward(engine: Engine, m, toks: torch.Tensor, q8: bool) -> torch.Tensor:
    """The merged layer stack (the reference's ``stack_fwd``) over toks
    (B, T): token t of sequence b at position ``seen[b] + t``, its K/V rows
    appended at its heads' ``tail_lens`` (a dense cache: ``lengths``; the
    counters are not advanced here), query rows given to the attention as
    (T, B·H, D) sequence-major. Returns the final hidden states (B, T, Dm).
    Reads nothing back."""
    cfg, params = engine.config, engine.params
    B, T = toks.shape
    L, H, Hkv, Dh = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    eps = cfg.rms_norm_eps
    lp_all = params["layers"]
    w4 = {k: v for k, v in lp_all.items() if _is_w4(v)}
    if "wq" in w4 or "w_gate" in w4:
        raise NotImplementedError(
            "the merged stack takes fused W4A8 stacks (wqkv, w_gateup) as the reference's "
            "does: its scanned layers leave the unfused v1 stacks out, so lp['wq'] has no "
            "path (kvzip_tpu/serving.py stack_fwd); fuse the tree first (fuse_w4a8_params)")
    x = embed_lookup(params["embed"], toks.reshape(B * T))
    pos = (m.seen[:, None] + torch.arange(T, device=toks.device)).reshape(B * T)
    cos, sin = rope_cos_sin(cfg.rope, Dh, pos)
    for l in range(L):
        lp = {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict) else v[l])
              for k, v in lp_all.items() if k not in w4}
        h = rms_norm(x, lp["ln_attn"], eps)
        if "wqkv" in w4:
            qkv = w4a8_linear_stacked(h, w4["wqkv"], l)
            nq, nk = H * Dh, Hkv * Dh
            q, k, v = qkv[:, :nq], qkv[:, nq:nq + nk], qkv[:, nq + nk:]
            if "bq" in lp:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        else:
            q, k, v = _lin_shared(h, (lp["wq"], lp["wk"], lp["wv"]),
                                  (lp.get("bq"), lp.get("bk"), lp.get("bv")))
        q = apply_rope(q.reshape(B * T, H, Dh), cos, sin)
        k = apply_rope(k.reshape(B * T, Hkv, Dh), cos, sin)
        # sequence-major merged heads: (T, B·Hkv, D) rows, (T, B·H, D) queries
        k_rows, v_rows = (a.reshape(B, T, Hkv, Dh).transpose(0, 1).reshape(T, B * Hkv, Dh)
                          for a in (k, v))
        if isinstance(m, KVCache):
            append_layer(m.k[l], m.v[l], m.lengths[l], k_rows, v_rows)
        else:
            append_layer(m.k_tail[l], m.v_tail[l], m.tail_lens, k_rows, v_rows)
        q2 = q.reshape(B, T, H, Dh).transpose(0, 1).reshape(T, B * H, Dh)
        attn = _attend(m, q2, l, scale, q8, B)
        attn = attn.reshape(T, B, H, Dh).transpose(0, 1).reshape(B * T, H * Dh)
        x = x + (w4a8_linear_stacked(attn, w4["wo"], l) if "wo" in w4 else _lin(attn, lp["wo"]))
        h2 = rms_norm(x, lp["ln_mlp"], eps)
        if "w_gateup" in w4:
            gate, up = w4a8_linear_stacked(h2, w4["w_gateup"], l).chunk(2, dim=-1)
        else:
            gate, up = _lin_shared(h2, (lp["w_gate"], lp["w_up"]), (None, None))
        hidden = _act(gate, cfg.hidden_act) * up
        x = x + (w4a8_linear_stacked(hidden, w4["w_down"], l) if "w_down" in w4
                 else _lin(hidden, lp["w_down"]))
    return x.reshape(B, T, -1)


def _logits(engine: Engine, x: torch.Tensor) -> torch.Tensor:
    params = engine.params
    xf = rms_norm(x, params["final_norm"], engine.config.rms_norm_eps)
    return head_logits(params.get("lm_head", params["embed"]), xf)


def _padded(engine: Engine, seqs: Sequence[np.ndarray]):
    """(B, round_up(max len, 8)) token ids, zero-padded, on the engine's
    device, and the true lengths (B,) int32 there."""
    n = np.asarray([len(s) for s in seqs], np.int32)
    toks = np.zeros((len(seqs), _round_up(int(n.max()), 8)), np.int64)
    for b, s in enumerate(seqs):
        toks[b, :len(s)] = s
    return torch.from_numpy(toks).to(engine.device), torch.from_numpy(n).to(engine.device)


class MergedDecodeStep(CapturedStep):
    """One greedy decode step over the merged cache with no host read (the
    body of the reference's merged ``run`` loop): forward each sequence's
    token at step i, write the argmax at i + 1 of a device token buffer
    (a sequence already done repeats its token), ``done |= token in eos``
    where eos stops the batch, and advance i and the counters of the
    sequences still running, all only while some sequence runs and i < the
    step budget. Captured and counted as ``engine.CapturedStep`` says.

    ``buf`` (int64): [i, done (B), tokens (Tcap + 1, B) step-major]; the
    host reads its head once a chunk of steps."""

    def __init__(self, engine: Engine, m, q8: bool):
        dev = engine.device
        self.engine, self.m, self.q8 = engine, m, q8
        self.B = B = m.seen.shape[0]
        self.cols = (m.capacity if isinstance(m, KVCache) else m.k_tail.shape[2]) + 1
        self.buf = torch.zeros(1 + B + self.cols * B, dtype=torch.int64, device=dev)
        self.i, self.done = self.buf[0:1], self.buf[1:1 + B]
        self.tokens = self.buf[1 + B:].view(self.cols, B)
        self.budget = torch.zeros(1, dtype=torch.int64, device=dev)
        self.stop = torch.zeros(1, dtype=torch.bool, device=dev)
        self.eos = torch.tensor(engine.eos_ids, dtype=torch.int64, device=dev)
        self._capture(dev, self.done)

    def step(self) -> None:
        m, B = self.m, self.B
        done = self.done != 0
        running = (~done).any() & (self.i < self.budget)  # (1,)
        cur = self.tokens.index_select(0, self.i)  # (1, B)
        x = _stack_forward(self.engine, m, cur.reshape(B, 1), self.q8)
        nxt = torch.argmax(_logits(self.engine, x[:, 0]), dim=-1)
        nxt = torch.where(done, cur[0], nxt)
        at = self.i + 1
        kept = self.tokens.index_select(0, at)[0]
        self.tokens.index_copy_(0, at, torch.where(running, nxt, kept)[None])
        hit = (nxt[:, None] == self.eos).any(-1) & self.stop
        now_done = done | (running & hit)
        adv = (running & ~now_done).to(torch.int32)
        self.done.copy_(now_done)
        _advance(m, adv)
        self.i += running

    def start(self, first: torch.Tensor, budget: int, stop_on_eos: bool) -> None:
        """A new run: token 0 ``first`` (B,), done where it is an eos token
        (with ``stop_on_eos``), ``budget`` steps at most."""
        first = first.to(device=self.buf.device, dtype=torch.int64)
        self.i.zero_()
        self.tokens[0].copy_(first)
        self.stop.fill_(stop_on_eos)
        self.done.copy_((first[:, None] == self.eos).any(-1) & self.stop)
        self.budget.fill_(budget)
        self.steps_read = 0

    def run(self, n: int):
        """n steps (replays on the card), then one host read: (i, done (B,)
        list, tokens (B, i + 1) ndarray)."""
        cols = min(self.steps_read + n, self.cols - 1) + 1
        head = self._run(n, 1 + self.B * (1 + cols))
        i = head[0]
        toks = np.asarray(head[1 + self.B:], np.int64).reshape(cols, self.B)[:i + 1].T
        return i, head[1:1 + self.B], toks


class MergedBatch:
    """B states merged into one cache (:func:`_merge_pool`,
    :func:`_merge_flat` or :func:`_merge_dense`), with its one decode step,
    captured at its first decode and kept for the batch's later ones
    (``capture_s``)."""

    def __init__(self, engine: Engine, states: Sequence[KVState]):
        caches = [st.cache for st in states]
        self.engine, self.states = engine, list(states)
        self.B = len(states)
        if isinstance(caches[0], KVCache):
            if any(type(c) is not KVCache for c in caches):
                raise ValueError("all caches in a batch must have the same type")
            self.cache = _merge_dense(caches)
            self.start_lengths = self.cache.lengths.clone()
            self.start_seen = self.cache.seen.clone()
        elif isinstance(caches[0], _MERGEABLE):
            pool = isinstance(caches[0], (PoolKV, PoolInt4KV))
            self.cache = (_merge_pool if pool else _merge_flat)(caches)
        else:
            raise NotImplementedError(
                f"{type(caches[0]).__name__} states have no batch path (nor in the "
                "reference): batch dense bf16 states, pools or flat caches")
        self.q8 = (engine.attn_quant == "int8"
                   and isinstance(caches[0], (PoolInt4KV, FlatInt4KV)))
        self.step: Optional[MergedDecodeStep] = None
        self.capture_s: Optional[float] = None

    def check_room(self, need: int) -> None:
        """The room check of a call (one host read): ``need`` more rows
        after the longest tail (a dense state: after its longest head, in
        its own capacity), and one for the last step's write."""
        m = self.cache
        if isinstance(m, KVCache):
            longest = m.lengths.reshape(m.lengths.shape[0], self.B, -1).amax(dim=(0, 2))
            for st, base in zip(self.states, longest.tolist()):
                if base + need + 1 > st.cache.capacity:
                    raise ValueError(f"merged decode needs {base + need + 1} rows > capacity "
                                     f"{st.cache.capacity}; raise decode_budget")
            return
        base = int(m.tail_lens.max())
        cap = m.k_tail.shape[2]
        if base + need + 1 > cap:
            raise ValueError(f"merged decode needs {base + need + 1} tail rows > capacity "
                             f"{cap}; raise decode_budget")

    def ingest(self, queries: Sequence[np.ndarray]) -> torch.Tensor:
        """The queries through the merged stack in one padded pass
        (Tq = round_up(longest, 8)); the counters advance by each query's
        true length. Returns the first tokens (B,)."""
        m = self.cache
        toks, n = _padded(self.engine, queries)
        x = _stack_forward(self.engine, m, toks, self.q8)
        xl = x[torch.arange(self.B, device=x.device), n.long() - 1]
        first = torch.argmax(_logits(self.engine, xl), dim=-1)
        _advance(m, n)
        return first

    def decode_step(self) -> MergedDecodeStep:
        """The batch's decode step, captured at its first use."""
        if self.step is None:
            self.step = MergedDecodeStep(self.engine, self.cache, self.q8)
            self.capture_s = self.step.capture_s
        return self.step

    def decode(self, first: torch.Tensor, max_steps: int, stop_on_eos: bool = True):
        """Greedy-decode up to ``max_steps`` steps after ``first`` (B,):
        (tokens (B, n + 1) with the first token, n)."""
        step = self.decode_step()
        step.start(first, max_steps, stop_on_eos)
        while True:
            i, done, toks = step.run(min(DECODE_CHUNK, max_steps - step.steps_read))
            if all(done) or i >= max_steps:
                return toks, i

    def check_distinct(self) -> None:
        """A batch that writes back holds each state once (a second copy's
        tail would overwrite the first's)."""
        if len({id(st) for st in self.states}) != self.B:
            raise ValueError("a state appears twice in a batch that writes back")

    def write_back(self) -> None:
        """Each state's grown tail (a dense state: the rows the batch wrote,
        from each head's length at the merge on) and counters, copied IN
        PLACE into its own tensors (its own captured decode step reads them
        by address)."""
        m = self.cache
        if isinstance(m, KVCache):
            Hkv = m.k.shape[1] // self.B
            start = self.start_lengths
            # every head of a sequence advanced alike: one host read of the widest
            n = int((m.seen - self.start_seen).max())
            for b, st in enumerate(self.states):
                c, heads = st.cache, slice(b * Hkv, (b + 1) * Hkv)
                # rows [start, start + n) of each (layer, head); a row past the
                # capacity is clamped to the last, which the merge copied too
                rows = (start[:, heads, None] + torch.arange(n, device=start.device)
                        ).clamp_max(c.capacity - 1).long()
                idx = rows[..., None].expand(-1, -1, -1, m.k.shape[-1])
                for f in ("k", "v"):
                    getattr(c, f).scatter_(2, idx, getattr(m, f)[:, heads].gather(2, idx))
                c.lengths.copy_(m.lengths[:, heads])
                c.seen.copy_(m.seen[b])
            return
        Hkv = m.k_tail.shape[1] // self.B
        for b, st in enumerate(self.states):
            c, heads = st.cache, slice(b * Hkv, (b + 1) * Hkv)
            c.k_tail.copy_(m.k_tail[:, heads])
            c.v_tail.copy_(m.v_tail[:, heads])
            c.tail_lens.copy_(m.tail_lens[heads])
            c.seen.copy_(m.seen[b])

    def segment(self, last_tokens, n_steps: int) -> np.ndarray:
        """Exactly ``n_steps`` tokens after ``last_tokens`` (B,) with no eos
        stop, written back to the states: (B, n_steps)."""
        self.check_distinct()
        self.check_room(n_steps)
        first = torch.as_tensor(np.asarray(last_tokens, np.int64), device=self.engine.device)
        tokens, _ = self.decode(first, n_steps, stop_on_eos=False)
        self.write_back()
        return tokens[:, 1:]


def _queries(engine: Engine, queries) -> List[np.ndarray]:
    return [engine.encode(q) if isinstance(q, str) else np.asarray(q, np.int32)
            for q in queries]


def _merged_decode(engine: Engine, states: Sequence[KVState], first_tokens, max_steps: int,
                   stop_on_eos: bool = True, queries=None, write_back: bool = True):
    """Greedy-decode ``max_steps`` tokens for B merged sequences.

    ``queries``: per-sequence query token ids, ingested batched through the
    merged stack, producing the first tokens (``first_tokens`` is ignored
    then); the room check (``base + Tq + max_steps + 1 <= Tcap``, one host
    read) raises before anything is written. Returns (tokens (B, n + 1)
    with the first token, n steps done); with ``write_back`` each state
    (each once in the batch) gets its grown tail and counters back in
    place, else the states are left as they were (the merged cache is a
    copy)."""
    batch = MergedBatch(engine, states)
    if write_back:
        batch.check_distinct()
    if queries is not None:
        queries = _queries(engine, queries)
        batch.check_room(_round_up(max(len(q) for q in queries), 8) + max_steps)
        first = batch.ingest(queries)
    else:
        batch.check_room(max_steps)
        first = torch.as_tensor(np.asarray(first_tokens, np.int64), device=engine.device)
    tokens, n = batch.decode(first, max_steps, stop_on_eos)
    if write_back:
        batch.write_back()
    return tokens, n


def _decode_segment(engine: Engine, states: Sequence[KVState], last_tokens: Sequence[int],
                    n_steps: int) -> np.ndarray:
    """Decode exactly ``n_steps`` greedy tokens for every state, batched,
    with no eos stop (continuous batching owns retirement). Returns (B,
    n_steps) new tokens; each state keeps its grown tail (the round loop
    owns snapshot and restore)."""
    return MergedBatch(engine, states).segment(last_tokens, n_steps)


def _trim(engine: Engine, seq: np.ndarray) -> np.ndarray:
    """The answer up to its first eos token."""
    stop = np.isin(seq, np.asarray(engine.eos_ids))
    return seq[:int(np.argmax(stop))] if stop.any() else seq


def batched_generate(engine: Engine, queries: Sequence, states: Sequence[KVState],
                     max_new_tokens: Optional[int] = None) -> List[str]:
    """Greedy-decode one query per compressed context, batched: the queries
    ingested together through the merged stack, then one merged decode
    step a token for the whole batch. The merged cache is a copy and
    nothing is written back, so every state is left as it was (where the
    reference snapshots and restores it) and one state may take several
    queries of a batch."""
    return [engine.decode(ids) for ids in
            batched_generate_ids(engine, queries, states, max_new_tokens)]


def batched_generate_ids(engine: Engine, queries: Sequence, states: Sequence[KVState],
                         max_new_tokens: Optional[int] = None) -> List[np.ndarray]:
    """:func:`batched_generate`, returning each answer's token ids (eos
    excluded)."""
    if len(queries) != len(states):
        raise ValueError(f"{len(queries)} queries for {len(states)} states")
    max_new = max_new_tokens or engine.max_new_tokens
    tokens, n = _merged_decode(engine, states, None, max_new - 1, queries=queries,
                               write_back=False)
    return [_trim(engine, tokens[b, :n + 1]).astype(np.int32) for b in range(len(states))]


def batched_logits(engine: Engine, seqs: Sequence[np.ndarray], states: Sequence[KVState],
                   ingest: Sequence[int]) -> List[np.ndarray]:
    """Next-token logits (len_b, V) float32 of every position of each
    sequence through the merged stack (teacher forcing): the first
    ``ingest[b]`` tokens of sequence b in one padded pass (as
    :func:`batched_generate` ingests its queries), the rest one token of
    every sequence a forward, the shapes of the merged decode step (all
    zeros: every token so). The states are untouched (the merged cache is
    a copy)."""
    batch = MergedBatch(engine, states)
    seqs = _queries(engine, seqs)
    m = batch.cache
    if any(ingest) and not all(ingest):
        raise ValueError(f"ingest lengths {list(ingest)}: all positive or all zero")
    rest = [s[k:] for s, k in zip(seqs, ingest)]
    steps = max(len(r) for r in rest)
    out: List[list] = [[] for _ in seqs]
    if any(ingest):
        toks, n = _padded(engine, [s[:k] for s, k in zip(seqs, ingest)])
        batch.check_room(toks.shape[1] + steps)
        x = _stack_forward(engine, m, toks, batch.q8)
        logits = _logits(engine, x.reshape(-1, x.shape[-1])).reshape(*x.shape[:2], -1)
        for b, k in enumerate(ingest):
            out[b].append(logits[b, :k].float())
        _advance(m, n)
    else:
        batch.check_room(steps)
    for t in range(steps):
        cur = torch.tensor([[int(r[t]) if t < len(r) else 0] for r in rest],
                           dtype=torch.int64, device=engine.device)
        x = _stack_forward(engine, m, cur, batch.q8)
        logits = _logits(engine, x[:, 0]).float()
        _advance(m, torch.ones_like(m.seen))
        for b, r in enumerate(rest):
            if t < len(r):
                out[b].append(logits[b:b + 1])
    return [torch.cat(o).cpu().numpy() for o in out]


class Scheduler:
    """Admission scheduler for batched decode.

    Requests (query, state) queue up; ``run`` drains them FIFO in batches of
    one cache class (flat int4, flat bf16, pool and dense states do not
    merge) and decodes each batch with one merged loop;
    ``run_continuous`` batches continuously. ``rounds`` logs each
    continuous round: its batch size, the requests admitted before it, and
    the capture seconds of its step (None where the round kept the last
    round's merged batch)."""

    def __init__(self, engine: Engine, max_batch: int = 8):
        self.engine = engine
        self.max_batch = max_batch
        self._queue: List[tuple] = []
        self.rounds: List[dict] = []

    def submit(self, query, state: KVState, max_new_tokens=None) -> int:
        """Enqueue one request; returns its request id."""
        rid = len(self._queue)
        self._queue.append((rid, query, state, max_new_tokens))
        return rid

    def run(self) -> List[str]:
        """Drain the queue; returns outputs ordered by request id. A batch
        of one goes through ``engine.generate``."""
        eng = self.engine
        out: dict = {}
        pending = list(self._queue)
        self._queue.clear()
        while pending:
            head_type = type(pending[0][2].cache)
            batch = [r for r in pending if isinstance(r[2].cache, head_type)][:self.max_batch]
            taken = {r[0] for r in batch}
            pending = [r for r in pending if r[0] not in taken]
            if len(batch) == 1:
                rid, q, st, mn = batch[0]
                out[rid] = eng.generate(q, st, max_new_tokens=mn or eng.max_new_tokens)
                continue
            max_new = max((r[3] or eng.max_new_tokens) for r in batch)
            results = batched_generate(eng, [r[1] for r in batch], [r[2] for r in batch],
                                       max_new_tokens=max_new)
            for (rid, *_), text in zip(batch, results):
                out[rid] = text
        return [out[i] for i in sorted(out)]

    def run_continuous(self, segment: int = 32) -> List[str]:
        """Drain the queue with CONTINUOUS batching: decode in rounds of
        ``segment`` steps; after each round finished sequences retire (their
        state restored for reuse) and queued requests are admitted into the
        freed slots mid-flight, each ingested alone through the engine's
        chunks. A request whose cache class differs from the batch's, or
        whose state is in the batch already, waits. A round whose batch is
        the last round's keeps its merged cache and captured step (the same
        tensors a re-merge would copy). Returns outputs ordered by request
        id."""
        eng = self.engine
        out: dict = {}
        pending = list(self._queue)
        self._queue.clear()
        slots: List[dict] = []
        batch, batch_rids = None, None

        def admit() -> int:
            n = 0
            while pending and len(slots) < self.max_batch:
                head_type = (type(slots[0]["state"].cache) if slots
                             else type(pending[0][2].cache))
                busy = {id(s["state"]) for s in slots}
                idx = next((i for i, r in enumerate(pending)
                            if isinstance(r[2].cache, head_type) and id(r[2]) not in busy), None)
                if idx is None:
                    break
                rid, q, st, mn = pending.pop(idx)
                q = _queries(eng, [q])[0]
                budget = mn or eng.max_new_tokens
                eng._check_capacity(st, len(q) + budget)
                st.snapshot()
                logits = eng._forward_chunks(q, st, "last")
                slots.append(dict(rid=rid, state=st, budget=budget,
                                  tokens=[int(torch.argmax(logits[-1]))]))
                n += 1
            return n

        admitted = admit()
        while slots:
            n_steps = min(segment, max(s["budget"] - len(s["tokens"]) + 1 for s in slots))
            rids = [s["rid"] for s in slots]
            kept = rids == batch_rids
            if not kept:
                batch, batch_rids = MergedBatch(eng, [s["state"] for s in slots]), rids
            toks = batch.segment([s["tokens"][-1] for s in slots], n_steps)
            self.rounds.append(dict(batch=len(slots), admitted=admitted, steps=n_steps,
                                    capture_s=None if kept else batch.capture_s))
            for s, seq in zip(slots, toks):
                s["tokens"].extend(int(t) for t in seq)
            keep = []
            for s in slots:
                if len(s["tokens"]) > s["budget"] or (
                        len(s["tokens"]) > 1 and s["tokens"][-1] in eng.eos_ids):
                    seq = _trim(eng, np.asarray(s["tokens"][:s["budget"]]))
                    out[s["rid"]] = eng.decode(seq)
                    s["state"].restore_snapshot()
                else:
                    keep.append(s)
            slots = keep
            admitted = admit()
        return [out[i] for i in sorted(out)]
