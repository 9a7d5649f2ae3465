"""Gemma3's hybrid forward over the ring-buffered cache (``HybridKV``).

Port of ``kvzip_tpu/models/hybrid.py::forward_hybrid``. The reference
scans over the layers and branches with ``lax.cond`` on the layer's kind;
here the layer loop is a Python loop that picks the branch by the layer's
index, which the host knows:

- a STATIC (global-attention) layer appends to its full-length stack
  (``k_static``/``v_static`` at the layer's slot among the static layers),
  is scored on the masked route (``reconstruction_scores``) and attends
  over its stack with the retain mask through ``attend_dense`` (capacity up
  to 4,096 rows, or ``attn_impl="dense"``) or ``attend_blockwise``; these
  are the layers KVzip scores and prunes;
- a SLIDING layer attends over its ring BEFORE this chunk's append plus the
  chunk itself (``attend_ring``, masked by stamped position and the
  window), then appends the chunk to the ring (``ring_append``); its score
  row is zero.

Every projection goes through ``_lin``/``_lin_shared`` per layer, as in
the reference: plain, W8A8, or a v1 W4A8 dict, which is K16
(``w4a8_matmul``) on the card, seven launches a layer. A fused or v2 W4A8
tree (``prepare_params(weight_quant="w4a8")``) has no path here, as it has
none in the reference: pass the unfused v1 tree with
``weight_quant="none"``. Nothing reads the device back: the ring slots
come from the device ``seen``, so a decode step over the hybrid cache can
be captured as a CUDA graph. Retain path only, as in the reference.
Under a ``mesh`` the static stacks and the rings hold the rank's kv heads
and the layer runs on its heads with ``forward``'s collectives
(``models/transformer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from kvzip_tpu_torch.cache import HybridKV, append_layer, ring_append
from kvzip_tpu_torch.config import ModelConfig
from kvzip_tpu_torch.models.rope import apply_rope, rope_cos_sin
from kvzip_tpu_torch.models.transformer import (ForwardResult, _act, _down, _lin_rows,
                                                _lin_shared, _local_heads, embed, final_logits, post_norm,
                                                qk_norm, rms_norm)
from kvzip_tpu_torch.ops.attention import (attend_blockwise, attend_dense, attend_ring,
                                           reconstruction_scores)
from kvzip_tpu_torch.parallel import collectives as tpc
from kvzip_tpu_torch.parallel.mesh import shard_of


def check_hybrid_params(layers: dict) -> None:
    """A hybrid forward takes one weight a projection (the reference's
    ``layer_params["wq"]``): a fused W4A8 stack, or v2 storage, raises."""
    fused = [n for n in ("wqkv", "w_gateup") if n in layers]
    v2 = [n for n, w in layers.items() if isinstance(w, dict) and "s2" in w]
    if fused or v2:
        raise ValueError(
            f"the hybrid (gemma3) forward takes unfused per-projection weights, not "
            f"{sorted(set(fused + v2))}: run W4A8 through the v1 route, the unfused v1 tree "
            "(init_params_w4a8, or load_hf_params(..., weight_quant='w4a8')) passed with "
            "weight_quant='none'; weight_quant='w4a8' fuses and repacks it")


def layer_slots(cfg: ModelConfig) -> list:
    """(is_static, slot) a layer: its index among the static or the
    sliding layers."""
    out, n_static, n_ring = [], 0, 0
    for l in range(cfg.num_layers):
        static = cfg.layer_is_static(l)
        out.append((static, n_static if static else n_ring))
        n_static, n_ring = n_static + static, n_ring + (not static)
    return out


def forward_hybrid(params, cfg: ModelConfig, ids: torch.Tensor, cache: HybridKV, *,
                   collect_logits: str = "none", scoring: bool = False,
                   score_start: int = 0, score_len: int = 0, score_qlen: int = 0,
                   score_width: int = 0, sink: int = 0, scoring_attend: str = "full",
                   attn_q8: bool = False, fuse_layer: str = "off", attn_impl: str = "dense",
                   advance: Optional[torch.Tensor] = None, mesh=None) -> ForwardResult:
    """Run ids (T,) through a hybrid config over ``cache`` in place, with
    ``forward``'s arguments and result. ``attn_impl``: the static layers'
    masked route, "dense" or "blockwise" (the capacity picks above 4,096
    rows unless "dense"); ``attn_q8`` and ``fuse_layer`` have no effect
    (no pool and no fused layer here), and the scoring is always the exact
    pass. ``advance``: as ``forward``'s; a ring row past ``seen +
    advance`` is not written. ``mesh``: as ``forward``'s."""
    if attn_impl not in ("dense", "blockwise"):
        raise ValueError(f"the hybrid forward runs the masked route, not {attn_impl!r}")
    if scoring_attend != "full":
        raise ValueError("scoring_attend='window' is not supported for hybrid (gemma3) models")
    lp_all = params["layers"]
    check_hybrid_params(lp_all)
    T = ids.shape[0]
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sh = None
    if mesh is not None:
        sh = shard_of(cfg, mesh)
        H, Hkv = sh.H, sh.Hkv
    scale = cfg.query_scale if cfg.query_scale is not None else Dh ** -0.5
    eps, gemma = cfg.rms_norm_eps, cfg.gemma_style_norm
    emb = params["embed"]
    dtype = emb["s"].dtype if isinstance(emb, dict) else emb.dtype
    window = int(cfg.sliding_window)
    dense = cache.capacity <= 4096 or attn_impl == "dense"

    x = embed(params, cfg, ids, mesh)
    positions = cache.seen + torch.arange(T, device=ids.device)
    rope_g = rope_cos_sin(cfg.rope, Dh, positions)
    rope_l = rope_g if cfg.rope_local is None else rope_cos_sin(cfg.rope_local, Dh, positions)
    seen = cache.seen  # advanced after the loop, so every layer reads the chunk's start
    scores = []
    for l, (static, slot) in enumerate(layer_slots(cfg)):
        lp = {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict) else v[l])
              for k, v in lp_all.items()}
        q, k, v = _lin_shared(rms_norm(x, lp["ln_attn"], eps, gemma),
                              (lp["wq"], lp["wk"], lp["wv"]),
                              (lp.get("bq"), lp.get("bk"), lp.get("bv")))
        if isinstance(lp["wq"], dict) and "q4" in lp["wq"]:
            q, k, v = _local_heads(q, k, v, sh, Dh)  # a replicated W4A8 weight
        q, k = qk_norm(cfg, lp, q.reshape(T, H, Dh), k.reshape(T, Hkv, Dh))
        cos, sin = rope_g if static else rope_l
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        v = v.reshape(T, Hkv, Dh)
        if static:
            k_l, v_l, base = cache.k_static[slot], cache.v_static[slot], cache.lengths[slot]
            append_layer(k_l, v_l, base, k, v)
            if scoring:
                win = slice(score_start, score_start + score_width)
                scores.append(reconstruction_scores(
                    q, k_l[:, :sink], k_l[:, win], k, score_len, scale=scale,
                    q_valid=score_qlen, model_dtype=dtype).to(dtype))
            attn = (attend_dense if dense else attend_blockwise)(
                q, k_l, v_l, base, cache.valid[slot], scale=scale)
        else:
            ring = (cache.k_ring[slot], cache.v_ring[slot], cache.ring_pos[slot])
            attn = attend_ring(q, *ring, k, v, seen, scale=scale, window=window)
            ring_append(*ring, seen, k, v, advance)
            if scoring:
                scores.append(torch.zeros((Hkv, score_width), dtype=dtype, device=x.device))
        o = _lin_rows(attn.reshape(T, H * Dh), lp["wo"], mesh)
        x = x + post_norm(cfg, lp, "ln_post_attn", o)
        gate, up = _lin_shared(rms_norm(x, lp["ln_mlp"], eps, gemma),
                               (lp["w_gate"], lp["w_up"]), (None, None))
        mlp = _down(_act(gate, cfg.hidden_act) * up, lp["w_down"], mesh)
        x = x + post_norm(cfg, lp, "ln_post_mlp", mlp)

    step = T if advance is None else advance
    cache.lengths += step
    cache.seen += step

    logits = None
    if collect_logits != "none":
        logits = final_logits(params, cfg, x if collect_logits == "all" else x[-1:], mesh)
    chunk_scores = torch.stack(scores) if scoring else None
    if scoring and sh is not None:
        chunk_scores = tpc.merge_replica_scores(chunk_scores, sh, mesh)
    return ForwardResult(logits, chunk_scores)
