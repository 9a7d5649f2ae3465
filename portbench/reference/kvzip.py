"""KVzip worked out again in plain float32: the document's KV, the
reconstruction scores, the global threshold and kept rows, and the logits
of queries and answers over the kept rows.

The semantics written out here, layer by layer:

- prefill: the system prompt (the sink) and the document, causal, at
  positions 0..P-1; the K/V rows cached (through int4 where the
  configuration states it);
- scoring: each chunk's repeat prompt (``prompts.repeat_prompts``) runs
  after the whole cache at positions P.., causal among itself; its own
  K/V rows take the cache's format. A chunk's scores are the softmax of its
  queries over [sink | the chunk's own rows | its repeat rows (causal)],
  maxed over the queries and the heads of a kv group, for the chunk's rows;
- prune (``keep_rows``): ``thres`` the element at descending index
  ``max(int(n r) - 1, 0)`` of every score of every layer and kv head; a
  row is kept where its score is above it; the sink is always kept;
- queries and answers run at positions P.. over each kv head's kept rows
  and, causally, their own rows, unquantized.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from portbench.reference.model import RefModel, attend
from portbench.reference.prompts import repeat_prompts


def keep_rows(score: torch.Tensor, ratio: float, sink: int) -> torch.Tensor:
    """The kept rows (L, Hkv, sink + ctx) of scores (L, Hkv, ctx)."""
    flat = score.reshape(-1).float()
    kth = max(int(flat.numel() * ratio) - 1, 0)
    thres = torch.sort(flat, descending=True).values[kth]
    L, Hkv, n = score.shape
    keep = torch.ones((L, Hkv, sink + n), dtype=torch.bool, device=score.device)
    keep[:, :, sink:] = score.float() > thres
    return keep


def compress(ref: RefModel, family: str, sink_ids: np.ndarray, ctx: np.ndarray, device,
             chunks: Optional[Sequence[int]] = None) -> dict:
    """The document's cache (K, V: (L, Hkv, P, D)) and the scores (L, Hkv,
    ctx) of the repeat chunks ``chunks`` (indices; all where None), the
    columns of the others zero."""
    ids = torch.as_tensor(np.concatenate([sink_ids, ctx]), device=device)
    sink, P = len(sink_ids), int(ids.numel())
    reps = repeat_prompts(family, np.asarray(ctx, np.int64))
    if chunks is not None:
        reps = [reps[c] for c in chunks]
    L, Hkv, D = ref.L, ref.Hkv, ref.D
    K = torch.empty((L, Hkv, P, D), dtype=torch.float32, device=device)
    V = torch.empty_like(K)
    score = torch.zeros((L, Hkv, len(ctx)), dtype=torch.float32, device=device)
    x = ref.embed(ids)
    xr = [ref.embed(torch.as_tensor(r, device=device)) for _, _, r in reps]
    pos = torch.arange(P, device=device)

    def causal(q0, q1, ncols):
        return (pos[None, :ncols] <= pos[q0:q1, None])[None]

    for l in range(L):
        w = ref.layer(l)
        q, k, v = ref.qkv(x, w, pos)
        K[l], V[l] = ref.kv(k).transpose(0, 1), ref.kv(v).transpose(0, 1)
        o = torch.empty_like(q)
        # a query block sees keys [0, t1) only: the causal mask's other columns
        step = 4096
        for t0 in range(0, P, step):
            t1 = min(P, t0 + step)
            o[t0:t1] = attend(q[t0:t1], K[l][:, :t1], V[l][:, :t1], ref.scale,
                              lambda a, b, t0=t0, t1=t1: causal(t0 + a, t0 + b, t1))
        for c, (start, n, r) in enumerate(reps):
            xr[c] = _repeat_layer(ref, w, xr[c], K[l], V[l], P, sink, start, n, score[l])
        x = ref.finish(x, o, w)
        del w, q, k, v, o
    return dict(K=K, V=V, score=score, P=P, cols=[(s, n) for s, n, _ in reps])


def _repeat_layer(ref: RefModel, w: dict, x: torch.Tensor, Kl, Vl, P: int, sink: int,
                  start: int, n: int, score_l: torch.Tensor) -> torch.Tensor:
    """One repeat prompt through one layer: attention over the cache and
    itself, and the chunk's scores written into ``score_l`` (Hkv, ctx)."""
    T = x.shape[0]
    dev = x.device
    q, k, v = ref.qkv(x, w, P + torch.arange(T, device=dev))
    k, v = ref.kv(k).transpose(0, 1), ref.kv(v).transpose(0, 1)
    Kc, Vc = torch.cat([Kl, k], dim=1), torch.cat([Vl, v], dim=1)
    col = torch.arange(P + T, device=dev)
    t_all = torch.arange(T, device=dev)

    def visible(t0, t1):
        return ((col[None, :] < P) | (col[None, :] - P <= t_all[t0:t1, None]))[None]

    o = attend(q, Kc, Vc, ref.scale, visible)
    # scores: the softmax over [sink | chunk rows | repeat rows]
    Ks = torch.cat([Kl[:, :sink], Kl[:, sink + start:sink + start + n], k], dim=1)
    cs = torch.arange(sink + n + T, device=dev)
    G = ref.H // ref.Hkv
    qg = q.reshape(T, ref.Hkv, G, ref.D).permute(1, 2, 0, 3)
    best = torch.zeros((ref.Hkv, n), dtype=torch.float32, device=dev)
    step = max(1, (1 << 27) // (ref.H * (sink + n + T)))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        s = torch.matmul(qg[:, :, t0:t1], Ks.transpose(1, 2)[:, None]) * ref.scale
        bad = (cs[None, :] >= sink + n) & (cs[None, :] - sink - n > t_all[t0:t1, None])
        p = torch.softmax(s.masked_fill(bad[None, None], float("-inf")), dim=-1)
        best = torch.maximum(best, p[..., sink:sink + n].amax(dim=(1, 2)))
    score_l[:, start:start + n] = best
    return ref.finish(x, o, w)


def answer_logits(ref: RefModel, doc: dict, keep: torch.Tensor, seqs: Sequence[np.ndarray],
                  first_rows: Sequence[int], device) -> List[torch.Tensor]:
    """Logits (float32) of each sequence (query ids, then the served answer
    but its last token) over the document's rows that ``keep`` (L, Hkv, P)
    keeps, from row ``first_rows[i]`` on (the query's last token)."""
    P = doc["P"]
    G = ref.H // ref.Hkv
    xs = [ref.embed(torch.as_tensor(np.asarray(s, np.int64), device=device)) for s in seqs]
    for l in range(ref.L):
        w = ref.layer(l)
        kept = keep[l].repeat_interleave(G, dim=0)  # (H, P)
        for i, x in enumerate(xs):
            T = x.shape[0]
            q, k, v = ref.qkv(x, w, P + torch.arange(T, device=device))
            Kc = torch.cat([doc["K"][l], k.transpose(0, 1)], dim=1)
            Vc = torch.cat([doc["V"][l], v.transpose(0, 1)], dim=1)
            ar = torch.arange(T, device=device)
            mask = torch.cat([kept[:, None, :].expand(-1, T, -1),
                              (ar[None, :] <= ar[:, None])[None].expand(ref.H, -1, -1)], dim=2)
            xs[i] = ref.finish(x, attend(q, Kc, Vc, ref.scale, lambda a, b, m=mask: m[:, a:b]), w)
        del w
    return [ref.logits(x[r:]) for x, r in zip(xs, first_rows)]


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: how far the token's reference logit lies below the
    reference's best, in units of that position's logit standard
    deviation over the vocabulary."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens[:, None].long())[:, 0]
    return (best - got) / ref_logits.std(dim=-1)
