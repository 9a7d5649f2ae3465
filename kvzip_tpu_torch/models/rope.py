"""Rotary position embeddings — default / linear / llama3 / yarn variants.

Port of ``kvzip_tpu/models/rope.py``: HuggingFace conventions (half-split
rotate, cos/sin duplicated over the two halves), frequencies in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kvzip_tpu_torch.config import RopeConfig


def _base_inv_freq(theta: float, dim: int) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def inv_frequencies(rope: RopeConfig, dim: int) -> np.ndarray:
    """Per-variant inverse frequencies (fp32 numpy, computed host-side once)."""
    inv_freq = _base_inv_freq(rope.theta, dim)

    if rope.scaling_type in ("default", "none") or rope.scaling_factor == 1.0 and \
            rope.scaling_type not in ("llama3", "yarn"):
        return inv_freq.astype(np.float32)

    if rope.scaling_type == "linear":
        return (inv_freq / rope.scaling_factor).astype(np.float32)

    if rope.scaling_type == "llama3":
        # HF modeling_rope_utils._compute_llama3_parameters
        factor = rope.scaling_factor
        low_freq_factor = rope.low_freq_factor
        high_freq_factor = rope.high_freq_factor
        old_context_len = rope.original_max_position_embeddings

        low_freq_wavelen = old_context_len / low_freq_factor
        high_freq_wavelen = old_context_len / high_freq_factor
        wavelen = 2 * math.pi / inv_freq

        inv_freq_llama = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_context_len / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_medium = (wavelen < low_freq_wavelen) & (wavelen > high_freq_wavelen)
        return np.where(is_medium, smoothed, inv_freq_llama).astype(np.float32)

    if rope.scaling_type == "yarn":
        # HF modeling_rope_utils._compute_yarn_parameters (beta_fast=32, beta_slow=1)
        factor = rope.scaling_factor
        orig_max = rope.original_max_position_embeddings
        beta_fast, beta_slow = 32.0, 1.0

        def find_dim(num_rotations):
            return (dim * math.log(orig_max / (num_rotations * 2 * math.pi))) / (
                2 * math.log(rope.theta))

        low = max(math.floor(find_dim(beta_fast)), 0)
        high = min(math.ceil(find_dim(beta_slow)), dim // 2 - 1)
        ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / max(high - low, 1e-3),
                       0.0, 1.0)
        extrapolation_factor = 1.0 - ramp
        inv_freq_interp = inv_freq / factor
        out = inv_freq_interp * (1 - extrapolation_factor) + inv_freq * extrapolation_factor
        return out.astype(np.float32)

    raise ValueError(f"unknown rope scaling {rope.scaling_type}")


def attention_scaling(rope: RopeConfig) -> float:
    """Multiplier on cos/sin (yarn mscale); 1.0 elsewhere."""
    if rope.scaling_type == "yarn":
        return 0.1 * math.log(rope.scaling_factor) + 1.0
    return 1.0


_INV_FREQ = {}  # (rope, dim, device) -> inv_freq (dim // 2,) float32


def _inv_freq(rope: RopeConfig, dim: int, device: torch.device) -> torch.Tensor:
    """inv_frequencies on ``device``, copied there once: a CUDA-graph
    capture of a decode step may not copy from the host."""
    key = (rope, dim, torch.device(device))
    t = _INV_FREQ.get(key)
    if t is None:
        t = _INV_FREQ[key] = torch.from_numpy(inv_frequencies(rope, dim)).to(device)
    return t


def rope_cos_sin(rope: RopeConfig, dim: int, positions: torch.Tensor):
    """cos/sin tables (T, dim) float32 for positions (T,) — the freqs
    duplicated over both halves (HF convention)."""
    inv_freq = _inv_freq(rope, dim, positions.device)
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = attention_scaling(rope)
    return torch.cos(emb) * scale, torch.sin(emb) * scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (T, n_heads, dim); cos/sin (T, dim). Computed in float32, cast back."""
    xf = x.float()
    c = cos.float()[:, None, :]
    s = sin.float()[:, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
