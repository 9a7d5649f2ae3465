"""Decoder forward of the port: dense (bf16 or int4) and pool branches.

Port of ``kvzip_tpu/models/transformer.py::forward`` for the llama and
qwen2 families (GQA, RoPE, optional qkv bias), with plain, W8A8 or W4A8
weights and a plain or int8 embedding / lm_head. PyTorch runs eagerly, so
the layer loop is a Python loop and the cache is updated in place.
Dispatch, as in the reference:

- ``attn_impl`` "flash" (the engine's ``_impl``); "dense" and "blockwise"
  send a dense cache's attention to the masked route instead
  (``ops/attention.py``: ``attend_dense``/``attend_blockwise`` with the
  layer's ``valid``, ``attend_blockwise_int4``), its scores to
  ``reconstruction_scores`` and its windowed scoring to
  ``windowed_scoring_attend`` (K2's and K9's plain versions), as the
  reference's XLA route: no kernel runs;
- dense bf16 cache: the KVzip score hook goes to K2 (``fused_scores``);
  T <= 8 queries go to K4 (``ragged_decode_attend``), longer blocks to K1
  (``flash_attend``);
- dense int4 cache: the chunk's rows are quantized (``quantize_int4``) and
  appended before attention, which goes to K5 (``flash_attend_int4``) at
  every T. Scoring is read-only: nothing is appended, K6
  (``flash_attend_int4_extra``) takes the chunk's quantized rows beside the
  cache, and K2 scores against the dequantized sink and window keys and the
  quantize-dequantized repeat keys;
- windowed scoring (``scoring_attend="window"``): the scoring pass attends
  only [sink | window | repeat] through K9 (``windowed_attend``) in place
  of K1/K4 (bf16 cache, where the chunk is still appended and the engine's
  snapshot restore drops it) or K6 (int4 cache, read-only; the repeat rows'
  K/V go through the cache's quantize-dequantize round trip); K2 still
  makes the scores;
- pool cache: K3 (``pool_decode_attend``) or, for an int4 pool, K7
  (``pool_decode_attend_int4``), after the T new rows are written into the
  full (L, Hkv, Tcap, D) tail stacks at ``tail_len`` (``index_copy_`` at
  rows the device forms; the kernels take the ``tail_lens`` vector);
- flat cache (``flat_decode="legacy"``): the same uniform tail append, then
  K10 (``flat_decode_attend``) or, for int4 rows, K11
  (``flat_decode_attend_int4``) on the stacked flat arrays and the layer's
  tail, at every T;
- ``attn_q8`` (``attn_quant="int8"``): K7 and K11 in their int8-attention
  mode (``q8``);
- W4A8 weights (fused ``wqkv`` and ``w_gateup`` or the unfused
  projections, ``wo``, ``w_down``) go through ``w4a8_linear_stacked``:
  below 512 rows K8 for v2 storage, K15 (``w4a8_matmul_stacked``) for v1;
  ``_lin`` takes a per-layer v1 dict to K16 (``w4a8_matmul``);
- ``fuse_layer`` ("auto" or "on"; "on" also on the CPU, where the plain
  version runs): a decode step of T <= 8 rows on a pool or flat cache with
  the four v2 W4A8 stacks takes the first layer's qkv composed before the
  loop, then one K12 (``w4a8_layer_fused``) per layer for o-proj, the MLP
  and the next layer's norm and qkv;
- W8A8 weights (``{"q", "s"}``): q/k/v share one activation quantization
  and gate/up another; with ``cfg.fused_act`` the RMSNorm and the
  quantization run as K13 (``rmsnorm_quant``) and act(gate) * up with the
  down projection's quantization as K14 (``silu_mul_quant``). The int8
  products go to ``int8_matmul`` (``torch._int_mm`` on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from kvzip_tpu_torch.cache import (FlatInt4KV, FlatKV, Int4KVCache, append_layer,
                                   append_layer_int4)
from kvzip_tpu_torch.config import ModelConfig
from kvzip_tpu_torch.models.rope import apply_rope, rope_cos_sin
from kvzip_tpu_torch.ops.attention import (attend_blockwise, attend_blockwise_int4,
                                           attend_dense)
from kvzip_tpu_torch.ops.flash import flash_attend
from kvzip_tpu_torch.ops.flash_int4 import flash_attend_int4, flash_attend_int4_extra
from kvzip_tpu_torch.ops.flat_decode import flat_decode_attend, flat_decode_attend_int4
from kvzip_tpu_torch.ops.fused_act import rmsnorm_quant, silu_mul_quant
from kvzip_tpu_torch.ops.pool_decode import pool_decode_attend, pool_decode_attend_int4
from kvzip_tpu_torch.ops.quant import (dequantize_int4, embed_lookup, head_logits,
                                       int8_linear, int8_matmul, is_w8,
                                       quantize_act_int8, quantize_int4)
from kvzip_tpu_torch.ops.ragged_decode import MAX_T, ragged_decode_attend
from kvzip_tpu_torch.ops.score_kernel import fused_scores, fused_scores_plain
from kvzip_tpu_torch.ops.w4a8 import w4a8_linear, w4a8_linear_stacked
from kvzip_tpu_torch.ops.w4a8_fused import MAX_T as FUSED_MAX_T
from kvzip_tpu_torch.ops.w4a8_fused import w4a8_layer_fused
from kvzip_tpu_torch.ops.windowed_attend import windowed_attend, windowed_attend_plain
from kvzip_tpu_torch.pool import PoolInt4KV, PoolKV


class ForwardResult(NamedTuple):
    logits: Optional[torch.Tensor]        # (T, V), (1, V) or None
    chunk_scores: Optional[torch.Tensor]  # (L, Hkv, score_width) or None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu_pytorch_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _lin(x: torch.Tensor, w, bias=None) -> torch.Tensor:
    """Linear of a plain (in, out) weight, a W8A8 dict or a v1 W4A8 dict."""
    if _is_w4(w):
        return w4a8_linear(x, w, bias)
    if is_w8(w):
        return int8_linear(x, w["q"], w["s"], bias)
    y = x @ w
    return y if bias is None else y + bias


def _lin_shared(x: torch.Tensor, weights, biases) -> list:
    """Several projections of one activation; W8A8 quantizes it once."""
    if is_w8(weights[0]):
        xq, xs = quantize_act_int8(x)
        return [int8_matmul(xq, xs, w["q"], w["s"], b, x.dtype)
                for w, b in zip(weights, biases)]
    return [_lin(x, w, b) for w, b in zip(weights, biases)]


def _norm_lin_shared(x: torch.Tensor, norm_w, eps: float, weights, biases,
                     fused: bool) -> list:
    """RMSNorm, then :func:`_lin_shared`; with ``fused`` and W8A8 weights
    the norm and the activation quantization are one K13 pass, in float32
    with no rounding to the model dtype between them."""
    if fused and is_w8(weights[0]):
        xq, xs = rmsnorm_quant(x, norm_w, eps)
        return [int8_matmul(xq, xs, w["q"], w["s"], b, x.dtype)
                for w, b in zip(weights, biases)]
    return _lin_shared(rms_norm(x, norm_w, eps), weights, biases)


def _is_w4(w) -> bool:
    return isinstance(w, dict) and "q4" in w


def _quantize_rows(k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The chunk's K/V rows (T, Hkv, D) in the int4 cache's form: (k_q,
    v_q, k_s, k_z, v_s, v_z), packed (T, Hkv, D//2), scales (T, Hkv)."""
    kq, ks, kz = quantize_int4(k, pack="split")
    vq, vs, vz = quantize_int4(v, pack="split")
    return kq, vq, ks[..., 0], kz[..., 0], vs[..., 0], vz[..., 0]


def _deq(packed, s, z, dtype):
    return dequantize_int4(packed, s[..., None], z[..., None], dtype, pack="split")


def _window_rows(layer, rep, sink: int, win: slice, dtype) -> torch.Tensor:
    """[sink | window | repeat] rows (Hkv, K, D) of one int4 layer's keys or
    values, dequantized; ``layer`` (packed, scale, zero) of the cache,
    ``rep`` the chunk's own quantized rows, which so take the same
    quantize-dequantize round trip as the cache's."""
    p, s, z = layer
    return torch.cat([_deq(p[:, :sink], s[:, :sink], z[:, :sink], dtype),
                      _deq(p[:, win], s[:, win], z[:, win], dtype),
                      _deq(*rep, dtype).transpose(0, 1)], dim=1)


def check_supported(cfg: ModelConfig) -> None:
    """The port's forward covers the llama and qwen2 families."""
    if (cfg.is_hybrid or cfg.qk_norm or cfg.post_norms
            or cfg.gemma_style_norm or cfg.rope_local is not None):
        raise NotImplementedError(
            f"{cfg.name}: only llama/qwen2-style decoders are ported")


def forward(params, cfg: ModelConfig, ids: torch.Tensor, cache, *,
            collect_logits: str = "none", scoring: bool = False,
            score_start: int = 0, score_len: int = 0, score_qlen: int = 0,
            score_width: int = 0, sink: int = 0,
            scoring_attend: str = "full", attn_q8: bool = False,
            fuse_layer: str = "off", attn_impl: str = "flash",
            advance: Optional[torch.Tensor] = None) -> ForwardResult:
    """Run ids (T,) through the model, appending their KV to ``cache`` in
    place (``lengths``/``seen``, or ``tail_lens``/``seen`` for a pool or a
    flat cache). Nothing here reads the device back, so a decode step can
    be captured as a CUDA graph; the caller makes sure a pool or flat
    cache's tail holds T more rows (the engine checks once a generate).

    ``collect_logits``: "none" | "last" | "all". ``scoring``: the KVzip
    repeat pass on a dense cache; ``score_start`` is the cache row of the
    scored ctx window, ``score_len`` its true length, ``score_qlen`` the
    true number of repeat queries. ``scoring_attend``: "full" (the exact
    pass over the whole cache) or "window" (K9 over [sink | window |
    repeat] only). ``attn_q8``: int8 attention on an int4 pool or flat
    cache (K7/K11 with ``q8``). ``fuse_layer``: "off", "auto" or "on", the
    fused W4A8 decode layer (K12) where its shapes allow ("auto" on the
    card only). ``attn_impl``: a dense cache's attention, "flash" (the
    kernels K1/K2/K4/K5/K6/K9, which read no retain mask) or "dense" /
    "blockwise" (the masked route of ``ops/attention.py`` with the layer's
    ``valid``, and the torch scoring and windowed attention); the engine's
    ``_impl`` picks it. A pool or flat cache always runs its kernels.
    ``advance``: a 0-dim int32 tensor the counters advance by
    instead of T (the engine's decode step gives 0 once its answer has
    ended: its rows then land past the live tail, where nothing reads
    them).
    """
    T = ids.shape[0]
    L, H, Hkv, Dh = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    is_flat = isinstance(cache, (FlatKV, FlatInt4KV))
    is_pool = isinstance(cache, (PoolKV, PoolInt4KV))
    is_int4 = isinstance(cache, Int4KVCache)
    if scoring and (is_pool or is_flat):
        raise ValueError("scoring runs before the prune; a pool or flat cache is decode-only")
    if scoring_attend not in ("full", "window"):
        raise ValueError(f"scoring_attend: {scoring_attend!r}")
    if fuse_layer not in ("off", "auto", "on"):
        raise ValueError(f"fuse_layer: {fuse_layer!r}")
    if attn_impl not in ("flash", "dense", "blockwise"):
        raise ValueError(f"attn_impl: {attn_impl!r}")
    flash = attn_impl == "flash"
    window = scoring and scoring_attend == "window"
    emb = params["embed"]
    dtype = emb["s"].dtype if isinstance(emb, dict) else emb.dtype

    x = embed_lookup(emb, ids)
    positions = cache.seen + torch.arange(T, device=ids.device)
    if is_pool or is_flat:
        # this step's tail rows, formed on the device
        tail_rows = cache.tail_len + torch.arange(T, device=ids.device)
    cos, sin = rope_cos_sin(cfg.rope, Dh, positions)
    lp_all = params["layers"]
    w4 = {k: v for k, v in lp_all.items() if _is_w4(v)}
    scores = []
    eps = cfg.rms_norm_eps
    # the fused layer (K12): decode shapes on a pool or flat cache with the
    # four v2 stacks; the first layer's qkv is composed before the loop
    fused = (fuse_layer != "off" and not scoring and (is_pool or is_flat)
             and T <= FUSED_MAX_T and (ids.is_cuda or fuse_layer == "on")
             and all(n in w4 and "s2" in w4[n]
                     for n in ("wqkv", "wo", "w_gateup", "w_down")))
    if fused:
        qkv = w4a8_linear_stacked(rms_norm(x, lp_all["ln_attn"][0], eps), w4["wqkv"], 0)
    for l in range(L):
        lp = {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[l]) for k, v in lp_all.items() if k not in w4}
        if "wqkv" in w4:
            if not fused:
                h = rms_norm(x, lp["ln_attn"], eps)
                qkv = w4a8_linear_stacked(h, w4["wqkv"], l)
            nq, nk = H * Dh, Hkv * Dh
            q, k, v = qkv[:, :nq], qkv[:, nq:nq + nk], qkv[:, nq + nk:]
            if "bq" in lp:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        elif "wq" in w4:
            h = rms_norm(x, lp["ln_attn"], eps)
            q, k, v = (w4a8_linear_stacked(h, w4[n], l, lp.get(b))
                       for n, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        else:
            q, k, v = _norm_lin_shared(
                x, lp["ln_attn"], eps, (lp["wq"], lp["wk"], lp["wv"]),
                (lp.get("bq"), lp.get("bk"), lp.get("bv")), cfg.fused_act)
        q = apply_rope(q.reshape(T, H, Dh), cos, sin)
        k = apply_rope(k.reshape(T, Hkv, Dh), cos, sin)
        v = v.reshape(T, Hkv, Dh)

        if is_pool or is_flat:
            # uniform tail append at tail_len (all heads advance together)
            cache.k_tail[l].index_copy_(1, tail_rows, k.transpose(0, 1))
            cache.v_tail[l].index_copy_(1, tail_rows, v.transpose(0, 1))
        if is_flat:
            tail = (cache.k_tail[l], cache.v_tail[l], cache.tail_lens)
            if isinstance(cache, FlatInt4KV):
                attn = flat_decode_attend_int4(
                    q, cache.k_flat_q, cache.k_flat_s, cache.k_flat_z, cache.v_flat_q,
                    cache.v_flat_s, cache.v_flat_z, cache.row_head, *tail, scale=scale,
                    q8=attn_q8, layer=l, seg_rows=cache.seg_rows, check_tail=False)
            else:
                attn = flat_decode_attend(q, cache.k_flat, cache.v_flat, cache.row_head,
                                          *tail, scale=scale, layer=l, seg_rows=cache.seg_rows,
                                          check_tail=False)
        elif is_pool:
            meta = (cache.row_head, cache.layer_off, cache.layer_rows,
                    cache.k_tail, cache.v_tail, cache.tail_lens, l)
            if isinstance(cache, PoolInt4KV):
                attn = pool_decode_attend_int4(
                    q, cache.k_pool_q, cache.k_pool_s, cache.k_pool_z,
                    cache.v_pool_q, cache.v_pool_s, cache.v_pool_z, *meta,
                    scale=scale, max_rows=cache.max_rows, q8=attn_q8, check_tail=False)
            else:
                attn = pool_decode_attend(q, cache.k_pool, cache.v_pool, *meta,
                                          scale=scale, max_rows=cache.max_rows,
                                          check_tail=False)
        elif is_int4:
            layer = (cache.k_q[l], cache.v_q[l], cache.k_s[l], cache.k_z[l],
                     cache.v_s[l], cache.v_z[l])
            base = cache.lengths[l]
            rows = _quantize_rows(k, v)
            kq_l, _, ks_l, kz_l = layer[:4]
            if scoring:
                win = slice(score_start, score_start + score_width)
                keys = _window_rows((kq_l, ks_l, kz_l), (rows[0], rows[2], rows[3]),
                                    sink, win, dtype)
                scores.append((fused_scores if flash else fused_scores_plain)(
                    q, keys, score_len, score_qlen, sink=sink,
                    s_ctx=score_width, scale=scale, model_dtype=dtype).to(dtype))
            if window:
                vals = _window_rows((layer[1], layer[4], layer[5]),
                                    (rows[1], rows[4], rows[5]), sink, win, dtype)
                attn = (windowed_attend if flash else windowed_attend_plain)(
                    q, keys, vals, score_len, sink=sink, s_ctx=score_width, scale=scale)
            elif scoring and flash:
                # read-only: the chunk's rows ride beside the cache
                attn = flash_attend_int4_extra(
                    q, layer[0], layer[2], layer[3], layer[1], layer[4], layer[5],
                    base, rows[0], rows[2], rows[3], rows[1], rows[4], rows[5],
                    scale=scale)
            else:
                # a scoring pass's rows land past the live lengths, which it
                # does not advance: they stay dead
                append_layer_int4(layer, base, rows)
                if flash:
                    attn = flash_attend_int4(q, layer[0], layer[2], layer[3], layer[1],
                                             layer[4], layer[5], base, scale=scale)
                else:
                    attn = attend_blockwise_int4(q, layer[0], layer[2], layer[3], layer[1],
                                                 layer[4], layer[5], base, cache.valid[l],
                                                 scale=scale)
        else:
            k_l, v_l, base = cache.k[l], cache.v[l], cache.lengths[l]
            append_layer(k_l, v_l, base, k, v)
            if scoring:
                win = slice(score_start, score_start + score_width)
                keys = torch.cat([k_l[:, :sink], k_l[:, win], k.transpose(0, 1)], dim=1)
                scores.append((fused_scores if flash else fused_scores_plain)(
                    q, keys, score_len, score_qlen, sink=sink,
                    s_ctx=score_width, scale=scale, model_dtype=dtype).to(dtype))
            if window:
                vals = torch.cat([v_l[:, :sink], v_l[:, win], v.transpose(0, 1)], dim=1)
                attn = (windowed_attend if flash else windowed_attend_plain)(
                    q, keys, vals, score_len, sink=sink, s_ctx=score_width, scale=scale)
            elif not flash:
                masked = attend_dense if attn_impl == "dense" else attend_blockwise
                attn = masked(q, k_l, v_l, base, cache.valid[l], scale=scale)
            elif T <= MAX_T:
                attn = ragged_decode_attend(q, k_l, v_l, base, scale=scale)
            else:
                attn = flash_attend(q, k_l, v_l, base, scale=scale)

        attn = attn.reshape(T, H * Dh)
        if fused:
            # the next layer's norm and qkv (its own weights, where the
            # reference's forward reads this layer's)
            x, qkv = w4a8_layer_fused(x, attn, lp_all["ln_mlp"], lp_all["ln_attn"], w4["wo"],
                                      w4["w_gateup"], w4["w_down"], w4["wqkv"], l, eps=eps,
                                      qkv_layer=min(l + 1, L - 1))
            continue
        if "wo" in w4:
            x = x + w4a8_linear_stacked(attn, w4["wo"], l)
        else:
            x = x + _lin(attn, lp["wo"])
        if "w_gateup" in w4:
            h2 = rms_norm(x, lp["ln_mlp"], eps)
            gate, up = w4a8_linear_stacked(h2, w4["w_gateup"], l).chunk(2, dim=-1)
        elif "w_gate" in w4:
            h2 = rms_norm(x, lp["ln_mlp"], eps)
            gate, up = (w4a8_linear_stacked(h2, w4[n], l) for n in ("w_gate", "w_up"))
        else:
            gate, up = _norm_lin_shared(x, lp["ln_mlp"], eps,
                                        (lp["w_gate"], lp["w_up"]), (None, None),
                                        cfg.fused_act)
        if "w_down" in w4:
            x = x + w4a8_linear_stacked(_act(gate, cfg.hidden_act) * up, w4["w_down"], l)
        elif cfg.fused_act and is_w8(lp["w_down"]):
            # act(gate) * up and its quantization as one K14 pass, feeding
            # the int8 down projection
            hq, hs = silu_mul_quant(gate, up, act=cfg.hidden_act)
            x = x + int8_matmul(hq, hs, lp["w_down"]["q"], lp["w_down"]["s"],
                                None, x.dtype)
        else:
            x = x + _lin(_act(gate, cfg.hidden_act) * up, lp["w_down"])

    step = T if advance is None else advance
    if is_pool or is_flat:
        cache.tail_lens += step  # tail_len, its view, moves with it
        cache.seen += step
    elif not (is_int4 and scoring):  # int4 scoring appended nothing
        # stream-ordered after every kernel above that read the old lengths
        cache.lengths += step
        cache.seen += step

    logits = None
    if collect_logits != "none":
        xf = x if collect_logits == "all" else x[-1:]
        xf = rms_norm(xf, params["final_norm"], cfg.rms_norm_eps)
        logits = head_logits(params.get("lm_head", params["embed"]), xf)
    return ForwardResult(logits, torch.stack(scores) if scoring else None)
