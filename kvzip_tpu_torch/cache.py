"""KV caches of the port: the dense caches (bf16 / float32, and int4) and
the flat decode layout built from them.

Port of ``kvzip_tpu/cache.py``. Dense: fixed-capacity buffers
``k/v (L, Hkv, C, D)`` with per-(layer, head) live lengths. Appends write in
place at ``lengths`` (where the reference donated its buffers to XLA), and
attention reads only ``[0, lengths)``, so dropping a query's rows is an O(1)
restore of the counters. A dense cache also holds ``valid (L, Hkv, C)``,
the retain path's mask (all True until :func:`set_retain_mask` writes it
in place), which the masked attention route applies; :func:`compact`
evicts physically into a smaller dense cache (``flat_decode="off"``).

Flat (the reference's round-3 layout, ``Engine(flat_decode="legacy")``):
every layer holds the same ``R_pad`` rows, its kept rows first, head-major
and in their original order, each tagged with its kv head in ``row_head``
(-1 on padding), plus per-layer tails ``(L, Hkv, Tcap, D)`` for the
query/answer KV. The port keeps K row-major ``(L, R_pad, D)`` like V (the
reference transposed K to ``(L, D, R_pad)`` for the TPU's matrix unit); the
int4 form holds split-packed rows ``(L, R_pad, D//2)`` with float32 scales
and zeros ``(L, R_pad)``. Each flat cache also keeps ``seg_rows`` (L, 1),
its layers' live rows (``row_head >= 0``, the first rows of each layer),
where the decode kernels K10/K11 stop reading.

Every counter lives on the device as int32, so a decode step reads none
of them back and can be captured as a CUDA graph: ``lengths``, where the
kernels read it; ``seen`` (the rope position base), a 0-dim tensor; and a
flat cache's tail length, ``tail_lens`` (Hkv,), the per-head vector the
decode kernels take, with ``tail_len`` its entry 0 (every head's tail
grows together). A constructor takes each as an int or a tensor
(:func:`device_counters`); forwards advance them in place, and
:func:`restore` copies a snapshot into them, so a captured step keeps
reading the same tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from kvzip_tpu_torch.config import ModelConfig


def device_counters(cache, n_heads: int = 0) -> None:
    """Make the counters a cache was constructed with int32 tensors of its
    own on its device (an int or a tensor given; a tensor is copied, so two
    caches never share one): ``seen`` 0-dim, and with ``n_heads`` (a pool
    or flat cache) ``tail_lens`` of ``n_heads`` equal entries, every head's
    tail length, with ``tail_len`` its entry 0 (a view that moves with
    it)."""
    dev = cache.lengths.device

    def own(v):
        return torch.as_tensor(v).to(device=dev, dtype=torch.int32).reshape(()).clone()

    cache.seen = own(cache.seen)
    if n_heads:
        cache.tail_lens = own(cache.tail_len).expand(n_heads).contiguous()
        cache.tail_len = cache.tail_lens[0]


def _init_valid(cache, rows: torch.Tensor) -> None:
    """A dense cache's retain mask (L, Hkv, C) bool, all True unless given."""
    if cache.valid is None:
        cache.valid = torch.ones(rows.shape[:3], dtype=torch.bool, device=rows.device)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (L, Hkv, C, D)
    v: torch.Tensor        # (L, Hkv, C, D)
    lengths: torch.Tensor  # (L, Hkv) int32 live rows
    seen: torch.Tensor     # () int32 tokens processed (an int given)
    # (L, Hkv, C) bool: the retain path's mask, which the masked route
    # applies as -inf (all True unless a retain prune wrote it)
    valid: torch.Tensor = None

    def __post_init__(self):
        device_counters(self)
        _init_valid(self, self.k)

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def mem_bytes(self) -> int:
        """Bytes held by the K and V buffers (the reference's count)."""
        return self.k.numel() * self.k.element_size() * 2

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
    seen: torch.Tensor     # () int32 (an int given)
    valid: torch.Tensor = None  # (L, Hkv, C) bool, as KVCache's

    def __post_init__(self):
        device_counters(self)
        _init_valid(self, self.k_s)

    @property
    def capacity(self) -> int:
        return self.k_q.shape[2]

    def mem_bytes(self) -> int:
        """Bytes held by packed K and V and their four scale and zero
        arrays (the reference's count)."""
        return (self.k_q.numel() + self.k_s.numel() * self.k_s.element_size() * 2) * 2

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


@dataclasses.dataclass
class FlatKV:
    """Flat decode cache: frozen context rows plus a per-layer tail."""

    k_flat: torch.Tensor    # (L, R_pad, D)
    v_flat: torch.Tensor    # (L, R_pad, D)
    row_head: torch.Tensor  # (L, R_pad) int32 kv head, -1 on padding
    k_tail: torch.Tensor    # (L, Hkv, Tcap, D)
    v_tail: torch.Tensor
    lengths: torch.Tensor   # (L, Hkv) int32 kept context rows (sink included)
    tail_len: torch.Tensor  # () int32, tail_lens[0] (an int given)
    seen: torch.Tensor      # () int32 (an int given)
    seg_rows: torch.Tensor  # (L, 1) int32 live rows a layer (they come first)

    def __post_init__(self):
        device_counters(self, self.k_tail.shape[1])  # tail_lens (Hkv,) int32

    @property
    def capacity(self) -> int:
        return self.k_flat.shape[1]

    def mem_bytes(self) -> int:
        """Bytes allocated for K and V: every layer's R_pad rows and tail."""
        return (self.k_flat.numel() + self.k_tail.numel()) * self.k_flat.element_size() * 2

    def used_bytes(self) -> float:
        rows = int(self.lengths.sum())
        return float(rows * self.k_flat.shape[-1] * self.k_flat.element_size() * 2)


@dataclasses.dataclass
class FlatInt4KV:
    """:class:`FlatKV` with int4 context rows (split packing, one quant
    group per row) and a tail in the model dtype."""

    k_flat_q: torch.Tensor  # (L, R_pad, D//2) uint8
    v_flat_q: torch.Tensor
    k_flat_s: torch.Tensor  # (L, R_pad) float32 scale
    k_flat_z: torch.Tensor  # (L, R_pad) float32 zero
    v_flat_s: torch.Tensor
    v_flat_z: torch.Tensor
    row_head: torch.Tensor  # (L, R_pad) int32
    k_tail: torch.Tensor    # (L, Hkv, Tcap, D) model dtype
    v_tail: torch.Tensor
    lengths: torch.Tensor   # (L, Hkv) int32
    tail_len: torch.Tensor  # () int32, tail_lens[0] (an int given)
    seen: torch.Tensor      # () int32 (an int given)
    seg_rows: torch.Tensor  # (L, 1) int32

    def __post_init__(self):
        device_counters(self, self.k_tail.shape[1])  # tail_lens (Hkv,) int32

    @property
    def capacity(self) -> int:
        return self.k_flat_q.shape[1]

    def mem_bytes(self) -> int:
        """Bytes allocated: packed rows, float32 scales and zeros, tail."""
        ctx = self.k_flat_q.numel() + self.k_flat_s.numel() * self.k_flat_s.element_size() * 2
        return (ctx + self.k_tail.numel() * self.k_tail.element_size()) * 2

    def used_bytes(self) -> float:
        """Live context bytes: packed row plus its float32 scale and zero,
        for K and V (the reference's count)."""
        row = self.k_flat_q.shape[-1] + 2 * self.k_flat_s.element_size()
        return float(int(self.lengths.sum()) * row * 2)


FLAT_INT4_FIELDS = ("k_flat_q", "v_flat_q", "k_flat_s", "k_flat_z", "v_flat_s",
                    "v_flat_z")
# the dense int4 cache's array behind each flat field
_DENSE_INT4 = dict(k_flat_q="k_q", v_flat_q="v_q", k_flat_s="k_s", k_flat_z="k_z",
                   v_flat_s="v_s", v_flat_z="v_z")


def full_keep(keep: torch.Tensor, sink: int, C: int) -> torch.Tensor:
    """(L, Hkv, C) bool: the sink rows, then ``keep`` (L, Hkv, ctx_len) over
    the context; rows past the context False."""
    L, H, ctx_len = keep.shape
    full = torch.zeros((L, H, C), dtype=torch.bool, device=keep.device)
    full[:, :, :sink] = True
    full[:, :, sink:sink + ctx_len] = keep.bool()
    return full


def flat_plan(keep: torch.Tensor, sink: int, r_pad: int, C: int):
    """The flat gather plan of the reference's ``_build_flat``: per layer,
    the dense (head * C + row) index of each flat row (kept rows first,
    head-major, in their original order), whether it is kept, the kept rows
    per (layer, head) with the sink, and ``row_head``. A layer holds
    ``min(r_pad, Hkv * C)`` rows, as the reference's slice gives."""
    L, H, _ = keep.shape
    keep_full = full_keep(keep, sink, C)
    flat = keep_full.reshape(L, H * C)
    take = torch.sort((~flat).to(torch.uint8), dim=1, stable=True).indices[:, :r_pad]
    kept = torch.gather(flat, 1, take)
    lengths = keep_full.sum(dim=-1).to(torch.int32)
    row_head = torch.where(kept, (take // C).to(torch.int32),
                           torch.full_like(take, -1, dtype=torch.int32))
    return take, kept, lengths, row_head


def live_rows(row_head: torch.Tensor) -> torch.Tensor:
    """(L, 1) int32: each layer's live flat rows (row_head >= 0), counted on
    the device (no sync); every flat build puts them first."""
    return (row_head >= 0).sum(dim=-1, keepdim=True).to(torch.int32)


def _gather_rows(a: torch.Tensor, take: torch.Tensor, kept: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """Dense (L, H, C, ...) -> flat (L, R, ...): rows at take, zero where
    not kept. One layer at a time, so the index never broadcasts over the
    row width."""
    L, H, C = a.shape[:3]
    out = torch.empty((L, take.shape[1], *a.shape[3:]), dtype=dtype or a.dtype,
                      device=a.device)
    for l in range(L):
        rows = a[l].reshape(H * C, *a.shape[3:])[take[l]]
        mask = kept[l].reshape(-1, *([1] * (a.dim() - 3)))
        out[l] = torch.where(mask, rows, torch.zeros((), dtype=a.dtype,
                                                      device=a.device)).to(out.dtype)
    return out


def _new_tails(L: int, H: int, tail_cap: int, D: int, dtype, device):
    return tuple(torch.zeros((L, H, tail_cap, D), dtype=dtype, device=device)
                 for _ in range(2))


def build_flat(cache: KVCache, keep: torch.Tensor, sink: int, r_pad: int,
               tail_cap: int) -> FlatKV:
    """Compact a dense cache into the flat layout (reference ``build_flat``).
    keep: (L, Hkv, ctx_len) bool over the context after the sink; r_pad:
    rows per layer, at least the largest layer's kept rows. The dense cache
    is left intact."""
    L, H, C, D = cache.k.shape
    take, kept, lengths, row_head = flat_plan(keep, sink, r_pad, C)
    k_tail, v_tail = _new_tails(L, H, tail_cap, D, cache.k.dtype, cache.k.device)
    return FlatKV(k_flat=_gather_rows(cache.k, take, kept),
                  v_flat=_gather_rows(cache.v, take, kept), row_head=row_head,
                  k_tail=k_tail, v_tail=v_tail, lengths=lengths, tail_len=0,
                  seen=cache.seen, seg_rows=live_rows(row_head))


def build_flat_int4(cache: Int4KVCache, keep: torch.Tensor, sink: int,
                    r_pad: int, tail_cap: int, dtype=torch.bfloat16) -> FlatInt4KV:
    """Compact a dense int4 cache into the flat layout (reference
    ``build_flat_int4``): packed rows move verbatim, scales and zeros become
    float32. The dense cache is left intact."""
    return _build_flat_int4(cache, keep, sink, r_pad, tail_cap, dtype, consume=False)


def build_flat_int4_stepped(cache: Int4KVCache, keep: torch.Tensor, sink: int,
                            r_pad: int, tail_cap: int,
                            dtype=torch.bfloat16) -> FlatInt4KV:
    """:func:`build_flat_int4` with bounded peak memory: the dense cache is
    consumed one array at a time (scales and zeros first, then the two
    packed arrays), each dropped from ``cache`` once gathered, so the peak
    is the live dense arrays plus one flat array, as the reference's
    donated steps give. ``cache`` is unusable afterwards."""
    return _build_flat_int4(cache, keep, sink, r_pad, tail_cap, dtype, consume=True)


def _build_flat_int4(cache, keep, sink, r_pad, tail_cap, dtype, consume: bool):
    L, H, C, Dp = cache.k_q.shape
    device = cache.k_q.device
    take, kept, lengths, row_head = flat_plan(keep, sink, r_pad, C)
    out = {}
    for f in ("k_flat_s", "k_flat_z", "v_flat_s", "v_flat_z", "k_flat_q", "v_flat_q"):
        src = _DENSE_INT4[f]
        out[f] = _gather_rows(getattr(cache, src), take, kept,
                              None if f.endswith("q") else torch.float32)
        if consume:
            setattr(cache, src, None)
    k_tail, v_tail = _new_tails(L, H, tail_cap, 2 * Dp, dtype, device)
    return FlatInt4KV(**out, row_head=row_head, k_tail=k_tail, v_tail=v_tail,
                      lengths=lengths, tail_len=0, seen=cache.seen,
                      seg_rows=live_rows(row_head))


def synthetic_full_flat(num_layers: int, num_kv_heads: int, head_dim: int,
                        per_head_rows: int, r_pad: int, tail_cap: int,
                        dtype=torch.bfloat16, device="cuda", int4: bool = False):
    """Full-occupancy flat cache with the row counts an all-rows-kept build
    gives (reference ``synthetic_full_flat_state``): the full-cache decode
    baseline after the dense cache is gone. Constant fill (the reference's
    values): decode time does not depend on them."""
    L, H, D = num_layers, num_kv_heads, head_dim
    rh = torch.full((r_pad,), -1, dtype=torch.int32)
    rh[:H * per_head_rows] = torch.arange(H, dtype=torch.int32).repeat_interleave(
        per_head_rows)
    k_tail, v_tail = _new_tails(L, H, tail_cap, D, dtype, device)
    row_head = rh.to(device)[None].repeat(L, 1)
    common = dict(row_head=row_head, k_tail=k_tail, v_tail=v_tail,
                  lengths=torch.full((L, H), per_head_rows, dtype=torch.int32,
                                     device=device),
                  tail_len=0, seen=per_head_rows, seg_rows=live_rows(row_head))

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    if int4:
        return FlatInt4KV(
            k_flat_q=full((L, r_pad, D // 2), 0x5A, torch.uint8),
            v_flat_q=full((L, r_pad, D // 2), 0xA5, torch.uint8),
            k_flat_s=full((L, r_pad), 0.01, torch.float32),
            k_flat_z=full((L, r_pad), -0.05, torch.float32),
            v_flat_s=full((L, r_pad), 0.01, torch.float32),
            v_flat_z=full((L, r_pad), -0.05, torch.float32), **common)
    return FlatKV(k_flat=full((L, r_pad, D), 0.02, dtype),
                  v_flat=full((L, r_pad, D), 0.03, dtype), **common)


def refold_flat(cache, r_pad_new: int):
    """Fold the committed tail rows (query/answer KV kept by
    ``update_cache=True`` turns) into the flat context, so the tail empties
    (reference ``refold_flat``).

    Per layer one stable sort by (kv head, flat rows before tail rows, pad
    rows last) and one gather; an int4 cache's tail rows are quantized
    (``quantize_int4``, split packing) like every other context row.
    ``r_pad_new``: rows per layer, at least the largest layer's kept rows
    plus ``Hkv * tail_len``. Returns a new cache whose ``tail_len`` is 0.
    """
    from kvzip_tpu_torch.ops.quant import quantize_int4

    is_int4 = isinstance(cache, FlatInt4KV)
    L, H, Tcap, D = cache.k_tail.shape
    dev = cache.row_head.device
    n = int(cache.tail_len)
    big = 2 ** 30
    key_flat = torch.where(cache.row_head >= 0, cache.row_head,
                           torch.full_like(cache.row_head, big))
    t_pos = torch.arange(Tcap, device=dev).repeat(H)
    key_tail = torch.where(t_pos < n,
                           torch.arange(H, dtype=torch.int32, device=dev).repeat_interleave(Tcap),
                           torch.full((H * Tcap,), big, dtype=torch.int32, device=dev))
    keys = torch.cat([key_flat, key_tail[None].expand(L, -1)], dim=1)
    take = torch.sort(keys, dim=1, stable=True).indices[:, :r_pad_new]
    key_taken = torch.gather(keys, 1, take)
    kept = key_taken < big
    row_head = torch.where(kept, key_taken, torch.full_like(key_taken, -1)).to(torch.int32)

    def fold(flat_rows, tail_rows):
        """(L, R, ...) context rows and (L, H * Tcap, ...) tail rows ->
        (L, r_pad_new, ...) in the new order, zero where not kept."""
        allr = torch.cat([flat_rows, tail_rows.to(flat_rows.dtype)], dim=1)
        out = torch.stack([allr[l][take[l]] for l in range(L)])
        mask = kept.reshape(*kept.shape, *([1] * (allr.dim() - 2)))
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=dev))

    tails = (cache.k_tail.reshape(L, H * Tcap, D), cache.v_tail.reshape(L, H * Tcap, D))
    common = dict(row_head=row_head, k_tail=torch.zeros_like(cache.k_tail),
                  v_tail=torch.zeros_like(cache.v_tail), lengths=cache.lengths + n,
                  tail_len=0, seen=cache.seen, seg_rows=live_rows(row_head))
    if not is_int4:
        return FlatKV(k_flat=fold(cache.k_flat, tails[0]),
                      v_flat=fold(cache.v_flat, tails[1]), **common)
    kq, ks, kz = quantize_int4(tails[0], pack="split")
    vq, vs, vz = quantize_int4(tails[1], pack="split")
    new = dict(k_flat_q=kq, k_flat_s=ks[..., 0], k_flat_z=kz[..., 0], v_flat_q=vq,
               v_flat_s=vs[..., 0], v_flat_z=vz[..., 0])
    return FlatInt4KV(**{f: fold(getattr(cache, f), new[f]) for f in FLAT_INT4_FIELDS},
                      **common)


_RESTORE_FIELDS = ("lengths", "seen", "tail_lens")


def snapshot(cache) -> dict:
    """Copies of the counters that a restore resets (forwards update them
    in place)."""
    return {f: getattr(cache, f).clone() for f in _RESTORE_FIELDS if hasattr(cache, f)}


def restore(cache, snap: dict) -> None:
    """O(1) counter reset: rows appended since the snapshot become dead.
    The snapshot is copied into the counters in place, so they stay the
    tensors a captured decode step reads."""
    for f, v in snap.items():
        getattr(cache, f).copy_(v)


def set_retain_mask(cache, keep: torch.Tensor, sink: int) -> None:
    """The retain path's prune (reference ``set_retain_mask``): ``valid``
    becomes [sink rows | ``keep`` over the context | every later row], and
    the masked route applies it as -inf. Written IN PLACE, so a pruned
    state can be pruned again at another ratio and a captured step keeps
    reading the same tensor."""
    cache.valid.fill_(True)
    cache.valid[:, :, sink:sink + keep.shape[-1]] = keep.bool()


def compact(cache, keep: torch.Tensor, sink: int, new_capacity: int):
    """Physical eviction into a dense cache of ``new_capacity`` rows a head
    (reference ``compact``, ``flat_decode="off"``): each (layer, head)'s
    kept rows, sink included, moved to its front in their original order
    by a stable sort, rows past its new length zeroed. One layer at a time
    (the gather index stays one layer's). Returns a new
    :class:`KVCache` or :class:`Int4KVCache` (the port's row-major packed
    rows) whose ``valid`` is all True; the input cache is left intact."""
    L, H, C = cache.valid.shape
    keep_full = full_keep(keep, sink, C)
    take = torch.sort((~keep_full).to(torch.uint8), dim=-1, stable=True).indices
    take = take[:, :, :new_capacity]
    lengths = keep_full.sum(dim=-1).to(torch.int32)
    live = (torch.arange(take.shape[-1], device=take.device)[None, None]
            < lengths[..., None])
    heads = torch.arange(H, device=take.device)[:, None]

    def gather(a):
        out = a.new_zeros((L, H, new_capacity, *a.shape[3:]))
        n = take.shape[-1]
        for l in range(L):
            rows = a[l][heads, take[l]]
            mask = live[l].reshape(H, n, *([1] * (a.dim() - 3)))
            out[l, :, :n] = rows.masked_fill(~mask, 0)
        return out

    common = dict(lengths=lengths, seen=cache.seen)
    if isinstance(cache, Int4KVCache):
        return Int4KVCache(**{f: gather(getattr(cache, f)) for f in
                              ("k_q", "v_q", "k_s", "k_z", "v_s", "v_z")}, **common)
    return KVCache(k=gather(cache.k), v=gather(cache.v), **common)
