"""Plain PyTorch attention over the dense cache and the KVzip score.

The plain versions of kernels K1, K2, K4, K5/K6 and K9 (``ops/flash.py``,
``ops/score_kernel.py``, ``ops/ragged_decode.py``, ``ops/flash_int4.py``,
``ops/windowed_attend.py``) and the CPU path of the port. Masking rule: key row ``j`` of kv head ``h`` is visible to query ``i``
(0-based within the new block) iff ``j < base_lens[h] + i + 1`` — the new
rows were appended at ``base_lens[h]``. Everything is computed in float32;
a row that sees no key gives 0.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def softmax_guarded(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis that gives 0 (not NaN) on all -inf rows."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(torch.isfinite(s), torch.exp(s - m), torch.zeros_like(s))
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-37)


def causal_mask(base: int, t0: int, t1: int, n_keys: int,
                device) -> torch.Tensor:
    """(t1 - t0, n_keys) visibility of keys to queries t0..t1-1."""
    col = torch.arange(n_keys, device=device)
    row = torch.arange(t0, t1, device=device)
    return col[None, :] < base + row[:, None] + 1


def attend_dense(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, base_lens: torch.Tensor, *,
                 scale: float) -> torch.Tensor:
    """Exact-softmax attention of q (T, H, D) over k/v (Hkv, C, D) with
    per-head base lengths; returns (T, H, D) in q's dtype."""
    T, H, D = q.shape
    Hkv, C, _ = k_cache.shape
    G = H // Hkv
    out = torch.empty((Hkv, G, T, D), dtype=torch.float32, device=q.device)
    for h, base in enumerate(base_lens.tolist()):
        n = min(base + T, C)
        qh = q[:, h * G:(h + 1) * G].float().transpose(0, 1)       # (G, T, D)
        s = qh @ k_cache[h, :n].float().T * scale                   # (G, T, n)
        s = s.masked_fill(~causal_mask(base, 0, T, n, q.device), NEG_INF)
        out[h] = softmax_guarded(s) @ v_cache[h, :n].float()
    return out.permute(2, 0, 1, 3).reshape(T, H, D).to(q.dtype)


def attend_blockwise(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, base_lens: torch.Tensor, *,
                     scale: float, kv_block: int = 1024,
                     q_block: int = 1024) -> torch.Tensor:
    """:func:`attend_dense` as an online softmax over key blocks, so memory
    stays O(q_block * kv_block) per head at long contexts."""
    return _attend_heads(q, lambda h, n: (k_cache[h, :n], v_cache[h, :n]),
                         k_cache.shape[1], base_lens, scale=scale,
                         kv_block=kv_block, q_block=q_block)


def _attend_heads(q: torch.Tensor, rows, C: int, base_lens: torch.Tensor, *,
                  scale: float, kv_block: int = 1024,
                  q_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention of q (T, H, D); ``rows(h, n)`` gives kv head
    h's first n key and value rows (n <= C). Query i sees the rows
    ``j < base_lens[h] + i + 1``."""
    T, H, D = q.shape
    Hkv = base_lens.shape[0]
    G = H // Hkv
    out = torch.empty((Hkv, G, T, D), dtype=torch.float32, device=q.device)
    for h, base in enumerate(base_lens.tolist()):
        k_h, v_h = rows(h, min(base + T, C))
        for t0 in range(0, T, q_block):
            t1 = min(t0 + q_block, T)
            qh = q[t0:t1, h * G:(h + 1) * G].float().transpose(0, 1)
            m = torch.full((G, t1 - t0, 1), NEG_INF, device=q.device)
            l = torch.zeros((G, t1 - t0, 1), device=q.device)
            acc = torch.zeros((G, t1 - t0, D), device=q.device)
            for c0 in range(0, min(base + t1, C), kv_block):
                c1 = min(c0 + kv_block, base + t1, C)
                s = qh @ k_h[c0:c1].float().T * scale
                mask = causal_mask(base, t0, t1, c1, q.device)[:, c0:]
                s = s.masked_fill(~mask, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                                    torch.zeros_like(m))
                p = torch.where(torch.isfinite(s), torch.exp(s - m_new),
                                torch.zeros_like(s))
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + p @ v_h[c0:c1].float()
                m = m_new
            out[h, :, t0:t1] = acc / l.clamp_min(1e-37)
    return out.permute(2, 0, 1, 3).reshape(T, H, D).to(q.dtype)


def attend_blockwise_int4(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                          kz: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                          vz: torch.Tensor, base_lens: torch.Tensor, *,
                          scale: float, kv_block: int = 512) -> torch.Tensor:
    """:func:`attend_blockwise` over the int4 cache: kq/vq (Hkv, C, D//2)
    split-packed uint8, ks/kz/vs/vz (Hkv, C) per-row scale and zero. Each
    head's live rows are dequantized in float32 (``ops/quant.py``)."""
    from kvzip_tpu_torch.ops.quant import dequantize_int4

    def rows(h, n):
        return tuple(dequantize_int4(p[h, :n], s[h, :n, None], z[h, :n, None],
                                     torch.float32, pack="split")
                     for p, s, z in ((kq, ks, kz), (vq, vs, vz)))

    return _attend_heads(q, rows, kq.shape[1], base_lens, scale=scale,
                         kv_block=kv_block)


def reconstruction_scores(q: torch.Tensor, k_sink: torch.Tensor,
                          k_ctx: torch.Tensor, k_rep: torch.Tensor,
                          ctx_len: int, *, scale: float, q_valid: int,
                          model_dtype: torch.dtype) -> torch.Tensor:
    """KVzip importance scores of one layer and one scoring chunk.

    Softmax over [sink | ctx window | repeat] keys, causal only on the
    trailing repeat block, ctx columns past ``ctx_len`` masked, logits
    rounded to ``model_dtype`` before the softmax, queries ``>= q_valid``
    dropped; the max over (group, query) of the ctx columns. Returns
    (Hkv, S_ctx) float32.

    q (T, H, D); k_sink (Hkv, S_sink, D); k_ctx (Hkv, S_ctx, D);
    k_rep (T, Hkv, D).
    """
    T, H, D = q.shape
    Hkv, S_sink, _ = k_sink.shape
    S_ctx = k_ctx.shape[1]
    G = H // Hkv
    s0 = S_sink + S_ctx
    keys = torch.cat([k_sink, k_ctx, k_rep.transpose(0, 1)], dim=1)
    col = torch.arange(s0 + T, device=q.device)[None, :]
    row = torch.arange(T, device=q.device)[:, None]
    bad = ((col >= s0) & (col - s0 > row)) | (
        (col >= S_sink + ctx_len) & (col < s0))
    out = torch.empty((Hkv, S_ctx), dtype=torch.float32, device=q.device)
    for h in range(Hkv):
        qh = q[:, h * G:(h + 1) * G].float().transpose(0, 1)        # (G, T, D)
        s = (qh @ keys[h].float().T * scale).masked_fill(bad, NEG_INF)
        p = softmax_guarded(s.to(model_dtype).float())
        p[:, q_valid:] = 0.0
        out[h] = p[:, :, S_sink:s0].amax(dim=(0, 1))
    return out


def windowed_scoring_attend(q: torch.Tensor, k_sink: torch.Tensor,
                            k_ctx: torch.Tensor, k_rep: torch.Tensor,
                            v_sink: torch.Tensor, v_ctx: torch.Tensor,
                            v_rep: torch.Tensor, ctx_len: int, *, scale: float,
                            out_dtype=torch.bfloat16) -> torch.Tensor:
    """Attention output of the scoring pass in windowed mode
    (``Engine(scoring_attend="window")``): the repeat queries attend only
    [sink | scored window | repeat] instead of the whole cache, which makes
    scoring O(ctx * window) instead of O(ctx^2). An approximation, except
    when one window covers the whole context.

    Masks as in :func:`reconstruction_scores`: causal only on the trailing
    T x T block, window columns past ``ctx_len`` dropped. Padded query rows
    are deliberately not masked: they attend real keys, so their outputs
    are finite, and the engine discards them (only the q_valid-masked
    scores leave the scoring forward). Float32 softmax. Returns (T, H, D)
    in ``out_dtype``.

    q (T, H, D); k_sink/v_sink (Hkv, S_sink, D); k_ctx/v_ctx
    (Hkv, S_ctx, D); k_rep/v_rep (T, Hkv, D).
    """
    T, H, D = q.shape
    Hkv, S_sink, _ = k_sink.shape
    S_ctx = k_ctx.shape[1]
    G = H // Hkv
    s0 = S_sink + S_ctx
    keys = torch.cat([k_sink, k_ctx, k_rep.transpose(0, 1)], dim=1)
    vals = torch.cat([v_sink, v_ctx, v_rep.transpose(0, 1)], dim=1)
    col = torch.arange(s0 + T, device=q.device)[None, :]
    row = torch.arange(T, device=q.device)[:, None]
    bad = ((col >= s0) & (col - s0 > row)) | (
        (col >= S_sink + ctx_len) & (col < s0))
    out = torch.empty((Hkv, G, T, D), dtype=torch.float32, device=q.device)
    for h in range(Hkv):
        qh = q[:, h * G:(h + 1) * G].float().transpose(0, 1)        # (G, T, D)
        s = (qh @ keys[h].float().T * scale).masked_fill(bad, NEG_INF)
        out[h] = softmax_guarded(s) @ vals[h].float()
    return out.permute(2, 0, 1, 3).reshape(T, H, D).to(out_dtype)
