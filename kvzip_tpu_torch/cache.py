"""Dense KV caches of the port: bf16 / float32, and int4.

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


@dataclasses.dataclass
class Int4KVCache:
    """int4 KV: split-packed nibbles with one (scale, zero) per row (one
    quant group of 128 per row, ``ops/quant.py``).

    The port keeps the packed rows row-major ``(C, D//2)``, where the
    reference transposed them to ``(D//2, C)`` for the TPU's matrix unit:
    a kernel loads a row's 64 bytes as four 16-byte pieces. Scales and
    zeros are stored in the model dtype, as in the reference.
    """

    k_q: torch.Tensor      # (L, Hkv, C, D//2) uint8
    v_q: torch.Tensor
    k_s: torch.Tensor      # (L, Hkv, C) scale
    k_z: torch.Tensor      # (L, Hkv, C) zero
    v_s: torch.Tensor
    v_z: torch.Tensor
    lengths: torch.Tensor  # (L, Hkv) int32 live rows
    seen: int

    @property
    def capacity(self) -> int:
        return self.k_q.shape[2]

    def used_bytes(self) -> float:
        """Live bytes of K and V: packed row plus its scale and zero."""
        row = self.k_q.shape[-1] + 2 * self.k_s.element_size()
        return float(int(self.lengths.sum()) * row * 2)


def init_cache(cfg: ModelConfig, capacity: int, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((L, H, capacity, D), dtype=dtype, device=device),
        v=torch.zeros((L, H, capacity, D), dtype=dtype, device=device),
        lengths=torch.zeros((L, H), dtype=torch.int32, device=device),
        seen=0)


def init_int4_cache(cfg: ModelConfig, capacity: int, dtype=torch.bfloat16,
                    device="cuda") -> Int4KVCache:
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if D != 128:
        raise ValueError("the int4 cache holds one quant group of 128 per row")

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Int4KVCache(
        k_q=z(L, H, capacity, D // 2, dt=torch.uint8),
        v_q=z(L, H, capacity, D // 2, dt=torch.uint8),
        k_s=z(L, H, capacity), k_z=z(L, H, capacity),
        v_s=z(L, H, capacity), v_z=z(L, H, capacity),
        lengths=torch.zeros((L, H), dtype=torch.int32, device=device), seen=0)


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


def append_layer_int4(layer: tuple, lens: torch.Tensor, quantized: tuple) -> None:
    """Write T quantized rows per head at each head's length, in place.

    layer: one layer's (k_q, v_q, k_s, k_z, v_s, v_z), each (H, C, ...);
    quantized: the rows' (k_q, v_q, k_s, k_z, v_s, v_z), each (T, H, ...)
    from ``quantize_int4(..., pack="split")`` (``ops/quant.py``)."""
    H = layer[0].shape[0]
    T = quantized[0].shape[0]
    heads = torch.arange(H, device=lens.device)[:, None]
    rows = lens.long()[:, None] + torch.arange(T, device=lens.device)[None]
    for dst, src in zip(layer, quantized):
        dst[heads, rows] = src.transpose(0, 1).to(dst.dtype)


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
