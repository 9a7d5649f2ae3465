"""Thresholding / pruning of KV importance scores.

Port of ``kvzip_tpu/prune.py``. Scores are a dense (L, H_kv, ctx_len)
tensor. The global threshold keeps ``score > thres`` (strict) where thres is
the element at descending index ``max(int(n * ratio) - 1, 0)``.
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _static_mask(valid: torch.Tensor, static_layers) -> torch.Tensor:
    """Rows of non-static layers come back all-True."""
    if static_layers is None:
        return valid
    mask = torch.zeros((valid.shape[0],), dtype=torch.bool, device=valid.device)
    mask[list(static_layers)] = True
    return torch.where(mask[:, None, None], valid, torch.ones_like(valid))


def _pool(score: torch.Tensor, static_layers) -> torch.Tensor:
    return score[list(static_layers)] if static_layers is not None else score


def threshold_global(score: torch.Tensor, ratio: float,
                     static_layers: Optional[Sequence[int]] = None
                     ) -> Tuple[torch.Tensor, float]:
    """One global threshold from a full sort: non-uniform per-head budgets."""
    if ratio >= 1:
        return torch.ones_like(score, dtype=torch.bool), 0.0
    flat = _pool(score, static_layers).reshape(-1).float()
    n = max(int(flat.numel() * ratio) - 1, 0)
    thres = torch.sort(flat, descending=True).values[n]
    valid = score.float() > thres
    return _static_mask(valid, static_layers), float(thres)


def threshold_histogram(score: torch.Tensor, ratio: float,
                        static_layers: Optional[Sequence[int]] = None,
                        bins: int = 4096, iters: int = 4
                        ) -> Tuple[torch.Tensor, float]:
    """The global threshold by iterative histogram refinement, without a
    full sort. A rank guard checks that the threshold is the exact k-th
    largest value (``#{x > t} <= k`` and ``#{x >= t} >= k + 1``); if not,
    it falls back to :func:`threshold_global`."""
    if ratio >= 1:
        return torch.ones_like(score, dtype=torch.bool), 0.0
    pool = _pool(score, static_layers).float().reshape(-1)
    k = max(int(pool.numel() * ratio) - 1, 0)
    lo = pool.min()
    hi = torch.nextafter(pool.max(), torch.tensor(float("inf"), device=pool.device))
    kk = torch.tensor(k, device=pool.device)
    for _ in range(iters):
        width = torch.clamp((hi - lo) / bins, min=1e-30)
        idx = torch.clamp(((pool - lo) / width).to(torch.int32), 0, bins - 1)
        inside = (pool >= lo) & (pool <= hi)
        counts = torch.bincount(idx[inside].long(), minlength=bins)
        cum = torch.cumsum(counts.flip(0), 0)
        j = torch.argmax((cum >= kk + 1).to(torch.int32))
        b = bins - 1 - j
        kk = kk - (cum[j] - counts[b])
        lo, hi = lo + b.float() * width, lo + (b + 1).float() * width
    inbin = (pool >= lo) & (pool < hi)
    thres = torch.where(inbin, pool, torch.full_like(pool, float("-inf"))).max()
    thres = torch.where(torch.isfinite(thres), thres, lo)
    n_gt, n_ge = int((pool > thres).sum()), int((pool >= thres).sum())
    if not (n_gt <= k and n_ge >= k + 1):
        warnings.warn(
            f"threshold_histogram rank guard tripped (#>thres={n_gt}, "
            f"#>=thres={n_ge}, k={k}); falling back to the sort-based "
            "global threshold")
        return threshold_global(score, ratio, static_layers)
    valid = score.float() > thres
    return _static_mask(valid, static_layers), float(thres)


def threshold_uniform(score: torch.Tensor, ratio: float,
                      static_layers: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, float]:
    """Per-head top-k: uniform budgets. Ties keep the lower index first."""
    if ratio >= 1:
        return torch.ones_like(score, dtype=torch.bool), 0.0
    L, H, n_seq = score.shape
    k = int(n_seq * ratio)
    idx = torch.sort(score.float(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    valid = torch.zeros((L, H, n_seq), dtype=torch.bool, device=score.device)
    valid.scatter_(-1, idx, True)
    return _static_mask(valid, static_layers), 0.0


def prune_mask(score: torch.Tensor, ratio: float, level: str = "pair",
               static_layers: Optional[Sequence[int]] = None,
               method: str = "sort") -> Tuple[torch.Tensor, float, float]:
    """Keep-mask for a compression ratio: (valid (L, H, ctx) bool,
    threshold, true_ratio). ``level``: "pair" (global threshold), "head"
    (the same on head-broadcast scores) or "pair-uniform" (per-head top-k);
    ``method``: "sort" or "histogram" for the global threshold."""
    if "uniform" in level:
        valid, thres = threshold_uniform(score, ratio, static_layers)
    elif method == "histogram":
        valid, thres = threshold_histogram(score, ratio, static_layers)
    else:
        valid, thres = threshold_global(score, ratio, static_layers)
    pool = _pool(valid, static_layers)
    return valid, thres, int(pool.sum()) / pool.numel()


def head_scores_to_pair(head_score: torch.Tensor, ctx_len: int) -> torch.Tensor:
    """Per-(layer, head) scores broadcast over the sequence."""
    return head_score[:, :, None].expand(*head_score.shape, ctx_len)


def load_head_score(model_name: str, ctx_len: int,
                    search_dirs: Sequence[str] = ("./head_score",)
                    ) -> torch.Tensor:
    """Load precomputed head scores (.npy/.npz/.pt), max-merged across
    files, as (L, H, ctx_len)."""
    key = model_name
    for prefix, short in (("Qwen2.5-7B", "qwen2.5-7b"),
                          ("Qwen2.5-14B", "qwen2.5-14b"),
                          ("Llama-3.1-8B", "llama3.1-8b")):
        if model_name.startswith(prefix):
            key = short
    paths = []
    for d in search_dirs:
        paths += sorted(glob.glob(os.path.join(d, f"{key}-*.np[yz]"))
                        + glob.glob(os.path.join(d, f"{key}-*.pt")))
    if not paths:
        cand = []
        for d in search_dirs:
            cand += glob.glob(os.path.join(d, "*.np[yz]"))
            cand += glob.glob(os.path.join(d, "*.pt"))
        low = key.lower()
        for path in sorted(cand):
            prefix = os.path.basename(path).rsplit(".", 1)[0].lower().split("-")[0]
            if low.startswith(prefix) or prefix.startswith(low):
                paths.append(path)
    arrays = []
    for path in paths:
        if path.endswith(".pt"):
            arr = torch.load(path, map_location="cpu",
                             weights_only=True).float().numpy().squeeze()
        elif path.endswith(".npz"):
            arr = np.load(path)["score"].squeeze()
        else:
            arr = np.load(path).squeeze()
        arrays.append(arr.astype(np.float32))
    if not arrays:
        raise FileNotFoundError(
            f"no head-score files for {key!r} in {list(search_dirs)}")
    merged = torch.from_numpy(np.stack(arrays, 0).max(axis=0))
    return head_scores_to_pair(merged, ctx_len)


def save_head_score(score: torch.Tensor, model_name: str, data_name: str,
                    idx: int, out_dir: str = "./head_score") -> str:
    """Persist per-head scores (max over the sequence) as .npz."""
    os.makedirs(out_dir, exist_ok=True)
    head = score.float().amax(dim=-1).cpu().numpy()
    path = os.path.join(out_dir, f"{model_name}-{data_name}-{idx}.npz")
    np.savez(path, score=head)
    return path
