"""Plain PyTorch attention over the dense cache and the KVzip score.

The masked route of the dense caches (the reference's XLA
``attend_dense``/``attend_blockwise``/``attend_blockwise_int4``, which the
engine picks with ``attn_impl="dense"``/``"blockwise"``: a pruned retain
cache, a head_dim the kernels are not built for), the plain versions of
kernels K1, K2, K4, K5/K6 and K9 (``ops/flash.py``,
``ops/score_kernel.py``, ``ops/ragged_decode.py``, ``ops/flash_int4.py``,
``ops/windowed_attend.py``) and the int8-attention arithmetic of K7 and
K11 (``attend_int4_q8``). Masking rule: key row ``j`` of kv head ``h`` is
visible to query ``i`` (0-based within the new block) iff ``j <
base_lens[h] + i + 1`` and ``valid[h, j]`` (the retain mask; None: every
row) — the new rows were appended at ``base_lens[h]``. Everything is
computed in float32; a row that sees no key gives 0. The masked route is
vectorized over kv heads and reads nothing back to the host (every key row
up to the capacity is scored and masked), so a decode step over it can be
captured as a CUDA graph. A sliding ``window`` (gemma3's local layers on a
dense cache) also hides row ``j`` from query ``i`` unless ``j > q_pos0 + i
- window``, ``q_pos0`` the query block's first position (a 0-dim device
tensor): a dense cache's row ``j`` holds position ``j`` until it is
pruned, and sliding layers are never pruned. :func:`attend_ring` is the
same sliding window over the hybrid cache's position-stamped ring.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = float("-inf")
# scores a kv head of one block may hold: 1,024 queries x 1,024 keys (a
# 16,384-token prefill at 32 heads would otherwise form 34 GB a layer)
BLOCK_SCORES = 1 << 20
KEY_BLOCK = 1024  # keys of one partial softmax in the blockwise route


def softmax_guarded(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis that gives 0 (not NaN) on all -inf rows."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(torch.isfinite(s), torch.exp(s - m), torch.zeros_like(s))
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-37)


def visible(base_lens: torch.Tensor, valid: Optional[torch.Tensor], t0: int, t1: int,
            c0: int, c1: int, q_pos0: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """(Hkv, t1 - t0, c1 - c0) visibility of keys c0..c1-1 to queries
    t0..t1-1, formed on the device; with ``window``, only the rows within
    ``window`` positions of the query (``q_pos0`` its block's first)."""
    dev = base_lens.device
    col = torch.arange(c0, c1, device=dev)
    row = torch.arange(t0, t1, device=dev)
    mask = col[None, None, :] < base_lens.long()[:, None, None] + row[None, :, None] + 1
    if valid is not None:
        mask = mask & valid[:, None, c0:c1]
    if window is not None:
        mask = mask & (col[None, None, :] > (q_pos0 + row - window)[None, :, None])
    return mask


def _group_queries(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q (T, H, D) -> float32 (Hkv, G, T, D): the G query heads of each kv
    head."""
    T, H, D = q.shape
    return q.float().reshape(T, n_kv, H // n_kv, D).permute(1, 2, 0, 3)


def _ungroup(out: torch.Tensor, dtype) -> torch.Tensor:
    Hkv, G, T, D = out.shape
    return out.permute(2, 0, 1, 3).reshape(T, Hkv * G, D).to(dtype)


def attend_dense(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, base_lens: torch.Tensor,
                 valid: Optional[torch.Tensor] = None, *,
                 scale: float, q_pos0: Optional[torch.Tensor] = None,
                 window: Optional[int] = None) -> torch.Tensor:
    """Exact-softmax attention of q (T, H, D) over k/v (Hkv, C, D) with
    per-head base lengths (Hkv,), the retain mask ``valid`` (Hkv, C) or
    None and a sliding ``window`` or None (``q_pos0`` the first query's
    position), every head at once; returns (T, H, D) in q's dtype."""
    T = q.shape[0]
    Hkv, C, _ = k_cache.shape
    qg = _group_queries(q, Hkv)
    s = torch.einsum("hgtd,hcd->hgtc", qg, k_cache.float()) * scale
    mask = visible(base_lens, valid, 0, T, 0, C, q_pos0, window)
    s = s.masked_fill(~mask[:, None], NEG_INF)
    out = torch.einsum("hgtc,hcd->hgtd", softmax_guarded(s), v_cache.float())
    return _ungroup(out, q.dtype)


def _online(qg: torch.Tensor, kv: Callable, C: int, mask_fn: Callable, *, scale: float,
            kv_block: Optional[int], q_block: int) -> torch.Tensor:
    """Online-softmax attention of qg (Hkv, G, T, D) float32 over blocks of
    ``kv_block`` keys (``kv(c0, c1)`` gives rows c0..c1-1 of every head as
    float32 (Hkv, n, D) keys and values; ``mask_fn(t0, t1, c0, c1)`` their
    visibility to queries t0..t1-1, (Hkv or 1, t1 - t0, c1 - c0) bool),
    queries in blocks of ``q_block``. As many key blocks as keep a query
    block's scores within ``BLOCK_SCORES`` a head are one batched product
    (each block's partial softmax merged after), so a decode step spreads
    its keys over the card in a fixed number of ops, and a long query block
    takes its keys a block at a time. A default block is halved (to 128 keys at least) until it
    divides the capacity, as the reference's is, so the keys need no
    padding. Returns (Hkv, G, T, D) float32."""
    Hkv, G, T, D = qg.shape
    kb = kv_block or KEY_BLOCK
    while not kv_block and C % kb and kb > 128:
        kb //= 2
    out = torch.empty_like(qg)
    for t0 in range(0, T, q_block):
        t1 = min(t0 + q_block, T)
        tq = t1 - t0
        qb = qg[:, :, t0:t1].reshape(Hkv, 1, G * tq, D)
        span = kb * max(1, BLOCK_SCORES // (tq * kb))  # keys a batched product
        m = torch.full((Hkv, G, tq, 1), NEG_INF, device=qg.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((Hkv, G, tq, D), device=qg.device)
        for c0 in range(0, C, span):
            c1 = min(c0 + span, C)
            nb = -(-(c1 - c0) // kb)
            pad = nb * kb - (c1 - c0)
            k_blk, v_blk = ((torch.nn.functional.pad(a, (0, 0, 0, pad)) if pad else a)
                            .reshape(Hkv, nb, kb, D) for a in kv(c0, c1))
            mask = mask_fn(t0, t1, c0, c1).expand(Hkv, tq, c1 - c0)
            if pad:
                mask = torch.nn.functional.pad(mask, (0, pad))
            mask = mask.reshape(Hkv, tq, nb, kb).permute(0, 2, 1, 3)[:, :, None]
            s = (qb @ k_blk.transpose(-1, -2) * scale).reshape(Hkv, nb, G, tq, kb)
            s = s.masked_fill(~mask, NEG_INF)
            m_b = s.amax(dim=-1, keepdim=True)                        # (Hkv, nb, G, tq, 1)
            p = torch.where(torch.isfinite(s), torch.exp(s - m_b), 0.0)
            o_b = (p.reshape(Hkv, nb, G * tq, kb) @ v_blk).reshape(Hkv, nb, G, tq, D)
            m_new = torch.maximum(m, m_b.amax(dim=1))
            w = torch.where(torch.isfinite(m_b), torch.exp(m_b - m_new[:, None]), 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            l = l * alpha + (p.sum(dim=-1, keepdim=True) * w).sum(dim=1)
            acc = acc * alpha + (o_b * w).sum(dim=1)
            m = m_new
        out[:, :, t0:t1] = acc / l.clamp_min(1e-37)
    return out


def attend_blockwise(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, base_lens: torch.Tensor,
                     valid: Optional[torch.Tensor] = None, *, scale: float,
                     q_pos0: Optional[torch.Tensor] = None, window: Optional[int] = None,
                     kv_block: Optional[int] = None, q_block: int = 1024) -> torch.Tensor:
    """:func:`attend_dense` as an online softmax over blocks of queries and
    keys, so memory stays within ``BLOCK_SCORES`` scores a head at long
    contexts."""
    out = _online(_group_queries(q, k_cache.shape[0]),
                  lambda c0, c1: (k_cache[:, c0:c1].float(), v_cache[:, c0:c1].float()),
                  k_cache.shape[1],
                  lambda t0, t1, c0, c1: visible(base_lens, valid, t0, t1, c0, c1, q_pos0,
                                                 window),
                  scale=scale, kv_block=kv_block, q_block=q_block)
    return _ungroup(out, q.dtype)


def attend_ring(q: torch.Tensor, k_ring: torch.Tensor, v_ring: torch.Tensor,
                ring_pos: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                seen: torch.Tensor, *, scale: float, window: int,
                kv_block: int = KEY_BLOCK, q_block: int = 1024) -> torch.Tensor:
    """Sliding-window attention of q (T, H, D), the queries at positions
    ``seen + i``, over the hybrid cache's ring of one layer BEFORE this
    chunk's append (k/v_ring (Hkv, W, D), ``ring_pos`` (W,) int32 each
    slot's token position, -1 empty) and the chunk's own rows k/v_new (T,
    Hkv, D): query i sees every column whose position p has ``p >= 0``, ``p
    <= seen + i`` and ``p > seen + i - window`` (the reference's
    ``attend_ring``). Appending first would evict rows that the chunk's
    early queries still need when T nears the window. An online softmax in
    float32 over blocks of ``kv_block`` keys (the chunk's rows first),
    vectorized over kv heads, no host read. Returns (T, H, D) in q's
    dtype."""
    T = q.shape[0]
    Hkv, W, _ = k_ring.shape
    pos = torch.cat([seen + torch.arange(T, device=q.device, dtype=torch.int32),
                     ring_pos.to(torch.int32)])

    def kv(c0, c1):
        ring_rows = slice(max(c0 - T, 0), max(c1 - T, 0))
        return tuple(torch.cat([new.transpose(0, 1)[:, c0:c1], ring[:, ring_rows]], dim=1).float()
                     for new, ring in ((k_new, k_ring), (v_new, v_ring)))

    def mask_fn(t0, t1, c0, c1):
        p = pos[None, c0:c1]
        q_pos = (seen + torch.arange(t0, t1, device=q.device))[:, None]
        return ((p >= 0) & (p <= q_pos) & (p > q_pos - window))[None]

    out = _online(_group_queries(q, Hkv), kv, T + W, mask_fn, scale=scale,
                  kv_block=kv_block, q_block=q_block)
    return _ungroup(out, q.dtype)


def attend_blockwise_int4(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                          kz: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                          vz: torch.Tensor, base_lens: torch.Tensor,
                          valid: Optional[torch.Tensor] = None, *, scale: float,
                          q_pos0: Optional[torch.Tensor] = None,
                          window: Optional[int] = None, kv_block: Optional[int] = None,
                          q_block: int = 1024) -> torch.Tensor:
    """:func:`attend_blockwise` over the int4 cache: kq/vq (Hkv, C, D//2)
    split-packed uint8, ks/kz/vs/vz (Hkv, C) per-row scale and zero. Each
    block's rows are dequantized in float32 (``ops/quant.py``)."""
    from kvzip_tpu_torch.ops.quant import dequantize_int4

    def kv(c0, c1):
        return tuple(dequantize_int4(p[:, c0:c1], s[:, c0:c1, None], z[:, c0:c1, None],
                                     torch.float32, pack="split")
                     for p, s, z in ((kq, ks, kz), (vq, vs, vz)))

    out = _online(_group_queries(q, kq.shape[0]), kv, kq.shape[1],
                  lambda t0, t1, c0, c1: visible(base_lens, valid, t0, t1, c0, c1, q_pos0,
                                                 window),
                  scale=scale, kv_block=kv_block, q_block=q_block)
    return _ungroup(out, q.dtype)


def head_rows(q: torch.Tensor, h: int, G: int) -> torch.Tensor:
    """The float32 query rows of kv head h from q (T, H, D), ordered as the
    decode kernels pack them: row g * T + i is query i of head h * G + g."""
    T, _, D = q.shape
    return q[:, h * G:(h + 1) * G].float().transpose(0, 1).reshape(G * T, D)


def put_head_rows(out: torch.Tensor, h: int, G: int, rows: torch.Tensor) -> None:
    """Write :func:`head_rows`-ordered rows (G * T, D) back into out (T, H, D)."""
    T, _, D = out.shape
    out[:, h * G:(h + 1) * G] = rows.reshape(G, T, D).transpose(0, 1)


def attend_rows(qr: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
                kt: torch.Tensor, vt: torch.Tensor, tail_ok: torch.Tensor, *,
                scale: float) -> torch.Tensor:
    """Exact attention of one kv head's query rows qr (R, D) over its
    context rows k/v_rows (n, D), all visible, and its tail kt/vt (m, D)
    under the mask tail_ok (R, m), in float32: the plain decode attention of
    the pool (K3/K7) and the flat layout (K10/K11), so the two give the same
    bits for the same rows."""
    s = torch.cat([qr @ k_rows.float().T,
                   (qr @ kt.float().T).masked_fill(~tail_ok, NEG_INF)], dim=-1) * scale
    return softmax_guarded(s) @ torch.cat([v_rows.float(), vt.float()], dim=0)


Q8_TILE = 64  # keys over which K7/K11 quantize p in q8 mode (their key tile)
# How far a kernel's float32 p (and its tile maximum) may stray from the
# plain version's, relative: the exponent's argument differs in its last
# bits (another summation order of sum(q), fused multiply-adds, a running
# maximum), which moves p by ~1e-6 of itself; 2^-18 leaves a margin of ~8.
Q8_P_RTOL = 2.0 ** -18


def _per127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 + 1e-20 with IEEE division, as the kernels compute it:
    PyTorch divides a CUDA tensor by a Python number as a product with the
    reciprocal, which differs in the last bit, and a scale one bit off
    rounds some s8 values the other way."""
    return torch.div(x, torch.full_like(x, 127.0)) + 1e-20


def _quantize_rows_s8(x: torch.Tensor):
    """Per-row symmetric s8 of the reference's q8 mode: scale amax / 127 +
    1e-20, round half to even (returned as float values)."""
    s = _per127(x.abs().amax(dim=-1, keepdim=True))
    return torch.round(x / s), s


def attend_int4_q8(qr: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                   kz: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                   vz: torch.Tensor, visible: torch.Tensor, kt: torch.Tensor,
                   vt: torch.Tensor, tail_ok: torch.Tensor, *, scale: float,
                   block: int = Q8_TILE, with_slack: bool = False):
    """Int8 attention (the reference's ``q8=True``) of one kv head's query
    rows qr (R, D) over a segment of int4 rows and a tail.

    kq/vq (n, D//2) split-packed uint8 and ks/kz/vs/vz (n,) float32 are the
    segment's rows from its row 0, ``visible`` (n,) which of them the head
    sees; kt/vt (m, D) the tail rows and ``tail_ok`` (R, m) their mask. The
    scores run as s8 dots of the per-row quantized q_hi = q[:D/2] / 16 and
    q_lo = q[D/2:] - q_hi against the bytes (``b ^ 0x80`` is ``b - 128``)
    and the low nibbles; p * v_scale is quantized per row over tiles of
    ``block`` rows aligned to the segment's row 0, as the kernels' key tiles
    are, and dotted with the bytes in s8. The integer sums are exact (float64
    here); everything else is float32, with one softmax maximum per row
    where the kernels keep a running one. Returns (R, D) float32, and with
    ``with_slack`` also how far a kernel's output may stray from it through
    quantized-p steps that flip (R, D): a kernel computes p to float32
    rounding, so a p * v_scale / ps_s that lies within 2 * 127 *
    ``Q8_P_RTOL`` of a .5 boundary may round the other way there, moving
    its row's output by ps_s * nibble / l; the slack sums that over every
    such p, and a parity gate discounts it (``ops.parity``'s ``slack``)."""
    D = qr.shape[1]
    half = D // 2
    qsum = qr.sum(dim=-1, keepdim=True)
    q_hi = qr[:, :half] * (1.0 / 16.0)
    q_lo = qr[:, half:] - q_hi
    qh8, qh_s = _quantize_rows_s8(q_hi)
    ql8, ql_s = _quantize_rows_s8(q_lo)
    n = kq.shape[0]
    nt = max(-(-n // block), 1)  # an empty segment still gets one (masked) tile
    pad = nt * block - n

    def padded(a, value=0):
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, pad), value=value)

    kq, vq, ks, kz, vs, vz = (padded(a) for a in (kq, vq, ks, kz, vs, vz))
    visible = padded(visible, False)
    kb, klo = kq.double() - 128.0, (kq & 15).double()
    a = (qh8.double() @ kb.T).float()
    m_lo = (ql8.double() @ klo.T).float()
    qn = qh_s * (a + 128.0 * qh8.sum(dim=-1, keepdim=True)) + ql_s * m_lo
    s = ((qn * ks + qsum * kz) * scale).masked_fill(~visible, NEG_INF)
    st = (qr @ kt.float().T * scale).masked_fill(~tail_ok, NEG_INF)
    m = torch.maximum(s.amax(dim=-1, keepdim=True), st.amax(dim=-1, keepdim=True))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m), torch.zeros_like(s))
    pt = torch.where(torch.isfinite(st), torch.exp(st - m), torch.zeros_like(st))
    R = qr.shape[0]
    ps = (p * vs).reshape(R, nt, block)
    ps_s = _per127(ps.amax(dim=-1, keepdim=True))                # (R, nt, 1)
    pp = torch.round(ps / ps_s)
    psum = pp.sum(dim=-1, keepdim=True)
    vb = (vq.double() - 128.0).reshape(nt, block, half)
    vlo = (vq & 15).double().reshape(nt, block, half)
    m1i = torch.einsum("rtb,tbd->rtd", pp.double(), vb).float()
    m2i = torch.einsum("rtb,tbd->rtd", pp.double(), vlo).float()
    m1 = ps_s * (m1i + 128.0 * psum)
    m2 = ps_s * m2i
    pz = (p * vz).reshape(R, nt, block).sum(dim=-1, keepdim=True)
    upd = torch.cat([(m1 - m2) * (1.0 / 16.0), m2], dim=-1) + pz  # (R, nt, D)
    acc = upd.sum(dim=1) + pt @ vt.float()
    l = p.sum(dim=-1, keepdim=True) + pt.sum(dim=-1, keepdim=True)
    out = acc / l.clamp_min(1e-37)
    if not with_slack:
        return out
    r = ps / ps_s
    near = (r - r.floor() - 0.5).abs() < 2 * 127 * Q8_P_RTOL
    w = (near * ps_s).reshape(R, nt * block) / l.clamp_min(1e-37)
    nib = torch.cat([vq >> 4, vq & 15], dim=-1).float()
    return out, w @ nib


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
    T = q.shape[0]
    Hkv, S_sink, _ = k_sink.shape
    S_ctx = k_ctx.shape[1]
    s0 = S_sink + S_ctx
    keys = torch.cat([k_sink, k_ctx, k_rep.transpose(0, 1)], dim=1).float()
    col = torch.arange(s0 + T, device=q.device)[None, :]
    row = torch.arange(T, device=q.device)[:, None]
    bad = ((col >= s0) & (col - s0 > row)) | (
        (col >= S_sink + ctx_len) & (col < s0))
    qg = _group_queries(q, Hkv)
    out = torch.zeros((Hkv, S_ctx), dtype=torch.float32, device=q.device)
    # queries >= q_valid score 0, so only the valid ones are formed, in
    # blocks of at most BLOCK_SCORES scores a head
    step = max(1, BLOCK_SCORES // (s0 + T))
    for t0 in range(0, min(q_valid, T), step):
        t1 = min(t0 + step, q_valid, T)
        s = torch.einsum("hgtd,hkd->hgtk", qg[:, :, t0:t1], keys) * scale
        p = softmax_guarded(s.masked_fill(bad[t0:t1], NEG_INF).to(model_dtype).float())
        out = torch.maximum(out, p[..., S_sink:s0].amax(dim=(1, 2)))
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
