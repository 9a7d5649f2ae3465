"""NIAH depth × context-length heatmap (reference `data/needle/visualize.py`).

Consumes the per-sample result JSONs written by the eval CLI for the
``needle`` dataset (ordered ctx-length-major, 11 depths each — see
`data/loaders.py::_load_niah`) and renders the retrieval-accuracy grid per
compression ratio. matplotlib only (seaborn is not in this image).
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional, Sequence

import numpy as np

DEPTHS = [i * 10 for i in range(11)]
DEFAULT_LENGTHS = [500, 2000, 8000]


def collect_scores(results_root: str, model: str, level: str = "pair",
                   ratio: float = 0.3, task: str = "qa") -> np.ndarray:
    """Returns accuracy grid (n_lengths, n_depths) for one ratio."""
    from kvzip_tpu_torch.eval.metrics import evaluate_answer

    files = sorted(
        glob.glob(os.path.join(results_root, "needle",
                               f"*_{model}", f"output-{level}.json")),
        key=lambda p: int(os.path.basename(os.path.dirname(p)).split("_")[0]))
    scores: List[float] = []
    for path in files:
        with open(path) as f:
            data = json.load(f)
        pred, answer = None, None
        for key in data:
            if not key.startswith(task):
                continue
            for info, text in data[key]:
                if abs(info[0] - ratio) < 1e-6:
                    pred, answer = text["pruned"], text["answer"]
        if pred is None:
            scores.append(np.nan)
        else:
            scores.append(evaluate_answer([pred], [answer], "needle", task)[0])

    n_depths = len(DEPTHS)
    n_lengths = max(1, len(scores) // n_depths)
    grid = np.full((n_lengths, n_depths), np.nan)
    for i, s in enumerate(scores[: n_lengths * n_depths]):
        grid[i // n_depths, i % n_depths] = s
    return grid


def plot_heatmap(grid: np.ndarray, out_path: str,
                 lengths: Optional[Sequence[int]] = None,
                 title: str = "NIAH retrieval accuracy") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lengths = lengths or DEFAULT_LENGTHS[: grid.shape[0]]
    fig, ax = plt.subplots(figsize=(8, 3 + 0.4 * grid.shape[0]))
    im = ax.imshow(grid, vmin=0, vmax=1, cmap="RdYlGn", aspect="auto")
    ax.set_xticks(range(len(DEPTHS)), [f"{d}%" for d in DEPTHS])
    ax.set_yticks(range(grid.shape[0]), [str(l) for l in lengths])
    ax.set_xlabel("needle depth")
    ax.set_ylabel("context length (tokens)")
    ax.set_title(title)
    for (i, j), v in np.ndenumerate(grid):
        if not np.isnan(v):
            ax.text(j, i, f"{v:.0%}", ha="center", va="center", fontsize=8)
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--level", default="pair")
    p.add_argument("-r", "--ratio", type=float, default=0.3)
    p.add_argument("--root", default="./results")
    p.add_argument("-o", "--out", default="needle_heatmap.png")
    args = p.parse_args()

    grid = collect_scores(args.root, args.model, args.level, args.ratio)
    path = plot_heatmap(grid, args.out,
                        title=f"NIAH accuracy — {args.model} @ ratio {args.ratio}")
    print("wrote", path)
