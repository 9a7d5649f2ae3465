"""Dense KV cache (bf16 or float32) of the port.

Port of the dense part of ``kvzip_tpu/cache.py``: fixed-capacity buffers
``k/v (L, Hkv, C, D)`` with per-(layer, head) live lengths. Appends write in
place at ``lengths`` (where the reference donated its buffers to XLA), and
attention reads only ``[0, lengths)``, so dropping a query's rows is an O(1)
restore of the counters.

``lengths`` stays on the device, where the kernels read it; ``seen`` (the
rope position base) is a host int.
"""

from __future__ import annotations

import dataclasses

import torch

from kvzip_tpu_torch.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (L, Hkv, C, D)
    v: torch.Tensor        # (L, Hkv, C, D)
    lengths: torch.Tensor  # (L, Hkv) int32 live rows
    seen: int              # tokens processed

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def used_bytes(self) -> float:
        rows = int(self.lengths.sum())
        return float(rows * self.k.shape[-1] * self.k.element_size() * 2)


def init_cache(cfg: ModelConfig, capacity: int, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((L, H, capacity, D), dtype=dtype, device=device),
        v=torch.zeros((L, H, capacity, D), dtype=dtype, device=device),
        lengths=torch.zeros((L, H), dtype=torch.int32, device=device),
        seen=0)


def append_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lens: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> None:
    """Write T new rows per head at each head's length, in place.

    k_cache/v_cache (H, C, D); lens (H,) int32; k_new/v_new (T, H, D). The
    row indices are formed on the device, so no length reaches the host.
    """
    H = k_cache.shape[0]
    T = k_new.shape[0]
    heads = torch.arange(H, device=k_cache.device)[:, None]
    rows = lens.long()[:, None] + torch.arange(T, device=k_cache.device)[None]
    k_cache[heads, rows] = k_new.transpose(0, 1).to(k_cache.dtype)
    v_cache[heads, rows] = v_new.transpose(0, 1).to(v_cache.dtype)


_RESTORE_FIELDS = ("lengths", "seen", "tail_len")


def snapshot(cache) -> dict:
    """The counters that a restore resets (device tensors are copied, since
    forwards update them in place)."""
    return {f: _copy(getattr(cache, f)) for f in _RESTORE_FIELDS
            if hasattr(cache, f)}


def restore(cache, snap: dict) -> None:
    """O(1) counter reset: rows appended since the snapshot become dead."""
    for f, v in snap.items():
        setattr(cache, f, _copy(v))


def _copy(v):
    return v.clone() if isinstance(v, torch.Tensor) else v
