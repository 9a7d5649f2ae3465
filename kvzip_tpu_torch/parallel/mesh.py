"""The device mesh and the sharding layout of the port's multi-device runs.

Port of ``kvzip_tpu/parallel/mesh.py``. The reference is one process over
a ``jax.sharding.Mesh``: PartitionSpecs describe where each array lives and
XLA inserts the collectives. The port runs one process a rank on
``torch.distributed`` (NCCL on the card, gloo on the CPU) over a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, ``("data", "model")`` or ``("replica", "data", "model")``. Each rank
holds only its own shard, as a plain local tensor: :func:`shard_params` and
:func:`shard_cache` take a full tree or cache and return the rank's part,
by the reference's spec table (:func:`param_pspecs`,
``_CACHE_FIELD_SPECS``):

- q/k/v, gate and up are column-parallel (heads or the intermediate on
  "model"), ``wo`` and ``w_down`` row-parallel, ``embed`` and ``lm_head``
  split over the vocabulary, norms replicated;
- W8A8 scales follow the output channel; the port's W8A8 int8 bytes are
  ``(L, out, in)``, the transpose of the reference's ``(L, in, out)``, so
  their spec is the transpose of the reference's;
- W4A8 trees (``{"q4", ...}``) stay replicated, as in the reference (its
  split packing pairs output columns j and j + OUT/2 in one byte);
- where "model" exceeds the kv heads (``tp % Hkv == 0``), each kv head is
  replicated over ``tp / Hkv`` ranks and its query heads are split among
  them (the reference's GSPMD does the same resharding for it);
- a vocabulary that "model" does not divide is split into chunks of
  ``ceil(V / tp)`` rows, the last one shorter, as XLA splits an uneven
  dimension; the sharded head pads its local logits with -inf to the
  chunk before the all-gather, so a pad column never wins the argmax.

The forward's collectives (``parallel/collectives.py``) run on the
mesh's "model" sub-group; ring prefill and data-parallel serving use
"data" (and "replica").
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from kvzip_tpu_torch.config import ModelConfig


class P(tuple):
    """A PartitionSpec: one entry a dimension, the mesh axis it is split
    over or None (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              replicas: int = 1, device_type: Optional[str] = None):
    """A ("data", "model") DeviceMesh over the process group the caller
    initialized, or ("replica", "data", "model") with ``replicas`` > 1.
    ``n_devices`` defaults to the world size and must equal it (one rank a
    device); ``tp`` defaults to all of a replica (pure tensor parallelism).
    The reference's assertions are ``ValueError``s here."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, the group has {world}")
    if n % replicas:
        raise ValueError(f"{n} devices not divisible by {replicas} replicas")
    per = n // replicas
    tp = tp or per
    if per % tp:
        raise ValueError(f"{per} devices/replica not divisible by tp={tp}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if replicas > 1:
        return init_device_mesh(device_type, (replicas, per // tp, tp),
                                mesh_dim_names=("replica", "data", "model"))
    return init_device_mesh(device_type, (per // tp, tp), mesh_dim_names=("data", "model"))


def axis_size(mesh, axis: str) -> int:
    """The size of a mesh axis, 1 where the mesh has no such axis."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on a mesh axis, 0 where it has none."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def mesh_shape(mesh) -> dict:
    """{axis name: size}, the reference's ``mesh.shape``."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def check_kv_heads(cfg: ModelConfig, tp: int) -> None:
    """The reference's rule: "model" divides the kv heads or is a multiple
    of them; the query heads and the intermediate split evenly."""
    Hkv = cfg.num_kv_heads
    if not (Hkv % tp == 0 or tp % Hkv == 0):
        raise ValueError(f"model axis {tp} incompatible with {Hkv} kv heads")
    if cfg.num_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(f"model axis {tp} does not divide {cfg.num_heads} heads "
                         f"and intermediate {cfg.intermediate_size}")


def check_mesh(cfg: ModelConfig, mesh, device: torch.device) -> None:
    """An engine's mesh: a "model" axis that fits ``cfg``'s heads, whose
    group is NCCL for a CUDA engine and gloo for a CPU one (no fallback:
    anything else raises)."""
    import torch.distributed as dist

    if "model" not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no 'model' axis: {mesh.mesh_dim_names}")
    backend = dist.get_backend(mesh.get_group("model"))
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"a {device.type} engine runs its mesh over {want}; "
                         f"the mesh's group is {backend}")
    check_kv_heads(cfg, axis_size(mesh, "model"))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's part of the model on the "model" axis: its query heads
    [h0, h0 + H), kv heads [kv0, kv0 + Hkv), intermediate [i0, i0 + I) and
    vocabulary rows [v0, v1) (chunks of ``v_chunk``); ``rep`` ranks share
    each kv head (``tp > num_kv_heads``), this one being ``rep_idx``."""

    tp: int
    rank: int
    H: int
    Hkv: int
    h0: int
    kv0: int
    I: int
    i0: int
    v0: int
    v1: int
    v_chunk: int
    rep: int
    rep_idx: int
    H_full: int
    Hkv_full: int
    V: int


def shard_geometry(cfg: ModelConfig, tp: int, rank: int) -> Shard:
    """Rank ``rank``'s :class:`Shard` of ``cfg`` at model axis ``tp``."""
    check_kv_heads(cfg, tp)
    H, Hkv, I, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    H_l = H // tp
    if Hkv % tp == 0:
        Hkv_l, kv0, rep, rep_idx = Hkv // tp, rank * (Hkv // tp), 1, 0
    else:
        rep = tp // Hkv
        Hkv_l, kv0, rep_idx = 1, rank // rep, rank % rep
    chunk = -(-V // tp)
    v0, v1 = min(rank * chunk, V), min((rank + 1) * chunk, V)
    return Shard(tp=tp, rank=rank, H=H_l, Hkv=Hkv_l, h0=rank * H_l, kv0=kv0, I=I // tp,
                 i0=rank * (I // tp), v0=v0, v1=v1, v_chunk=chunk, rep=rep, rep_idx=rep_idx,
                 H_full=H, Hkv_full=Hkv, V=V)


@functools.lru_cache(maxsize=None)
def shard_of(cfg: ModelConfig, mesh) -> Shard:
    """This rank's :class:`Shard` of ``cfg`` on ``mesh``'s "model" axis."""
    return shard_geometry(cfg, axis_size(mesh, "model"), axis_rank(mesh, "model"))


def local_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """``cfg`` with this rank's head counts and intermediate width (the
    shape of its cache and its layer weights); ``cfg`` itself without a
    mesh."""
    if mesh is None:
        return cfg
    sh = shard_of(cfg, mesh)
    return dataclasses.replace(cfg, num_heads=sh.H, num_kv_heads=sh.Hkv,
                               intermediate_size=sh.I)


# ------------------------------------------------------------------ specs
def param_pspecs(cfg: ModelConfig) -> dict:
    """PartitionSpecs of the parameter tree (Megatron TP over heads), in
    the reference's plain-weight layout ``(L, in, out)``."""
    lp = {
        "wq": P(None, None, "model"),
        "wk": P(None, None, "model"),
        "wv": P(None, None, "model"),
        "wo": P(None, "model", None),
        "w_gate": P(None, None, "model"),
        "w_up": P(None, None, "model"),
        "w_down": P(None, "model", None),
        "ln_attn": P(), "ln_mlp": P(),
        "bq": P(None, "model"), "bk": P(None, "model"), "bv": P(None, "model"),
        "q_norm": P(), "k_norm": P(),
        "ln_post_attn": P(), "ln_post_mlp": P(),
    }
    return {"embed": P("model", None), "layers": lp, "final_norm": P(),
            "lm_head": P("model", None)}


def cache_pspecs() -> dict:
    """KV cache spec: kv heads on "model" (k/v/lengths/valid head-sharded)."""
    return {"k": P(None, "model", None, None), "v": P(None, "model", None, None),
            "lengths": P(None, "model"), "seen": P(), "valid": P(None, "model", None)}


# Field name -> PartitionSpec for every cache of the port (dense KVCache,
# Int4KVCache, gemma3 HybridKV): the kv-head axis rides "model" wherever it
# appears; the counters and the rings' position stamps stay replicated. The
# port's int4 rows are (L, Hkv, C, D/2), its scales and zeros (L, Hkv, C).
_CACHE_FIELD_SPECS = {
    "k": P(None, "model", None, None),
    "v": P(None, "model", None, None),
    "k_q": P(None, "model", None, None),
    "v_q": P(None, "model", None, None),
    "k_s": P(None, "model", None),
    "k_z": P(None, "model", None),
    "v_s": P(None, "model", None),
    "v_z": P(None, "model", None),
    "k_static": P(None, "model", None, None),
    "v_static": P(None, "model", None, None),
    "k_ring": P(None, "model", None, None),
    "v_ring": P(None, "model", None, None),
    "ring_pos": P(),
    "lengths": P(None, "model"),
    "valid": P(None, "model", None),
    "seen": P(),
}


def _trim(tree_specs: dict, tree: dict) -> dict:
    """The spec of every leaf of ``tree`` (missing entries replicated), in
    the port's layout: a W8A8 dict's int8 bytes ``(L, out, in)`` take the
    transpose of the weight's spec and its scales ``(L, out)`` the output
    axis; W4A8 dicts stay replicated."""
    out = {}
    for k, v in tree.items():
        spec = tree_specs.get(k)
        if isinstance(v, dict):
            if isinstance(spec, P) and set(v) == {"q", "s"}:
                if len(spec) == 3:   # a layer stack
                    out[k] = {"q": P(spec[0], spec[2], spec[1]), "s": P(spec[0], spec[2])}
                else:                # an int8 embedding / head table (V, D), (V,)
                    out[k] = {"q": spec, "s": P(spec[0])}
            elif "q4" in v:
                out[k] = {kk: P() for kk in v}
            else:
                out[k] = _trim(spec if isinstance(spec, dict) else {}, v)
        else:
            out[k] = spec if spec is not None else P()
    qkv = tree.get("wqkv", tree.get("wq"))
    if isinstance(qkv, dict) and "q4" in qkv:
        # a replicated W4A8 projection's biases stay with it: the forward
        # adds them to the whole q/k/v before keeping the rank's heads
        out.update({b: P() for b in ("bq", "bk", "bv") if b in tree})
    return out


def param_sharding(cfg: ModelConfig, mesh, params: dict) -> dict:
    """The spec of every leaf of ``params`` (the reference returns
    NamedShardings; the port's ranks slice by the specs themselves)."""
    return _trim(param_pspecs(cfg), params)


def cache_sharding(mesh) -> dict:
    return dict(cache_pspecs())


# ---------------------------------------------------------------- slicing
_KV_LEAVES = ("wk", "wv", "bk", "bv")
_VOCAB_LEAVES = ("embed", "lm_head")


def _take(t: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    """t's [start, stop) along dim: a view where that is all of t, else a
    copy of its own (the full tensor can then be freed)."""
    if start == 0 and stop == t.shape[dim]:
        return t
    return t.narrow(dim, start, stop - start).contiguous()


def _slice_leaf(t: torch.Tensor, spec: P, name: str, sh: Shard, head_dim: int):
    """A leaf's part on rank ``sh.rank``: the "model" dimension of its spec
    cut by what it holds: query heads, kv heads, the intermediate or the
    vocabulary."""
    if "model" not in spec:
        return t
    dim = spec.index("model")
    if name in _VOCAB_LEAVES:
        return _take(t, dim, sh.v0, sh.v1)
    if name in _KV_LEAVES:
        return _take(t, dim, sh.kv0 * head_dim, (sh.kv0 + sh.Hkv) * head_dim)
    if name in ("wq", "bq", "wo"):
        return _take(t, dim, sh.h0 * head_dim, (sh.h0 + sh.H) * head_dim)
    n = t.shape[dim] // sh.tp
    return _take(t, dim, sh.rank * n, (sh.rank + 1) * n)


def local_params(cfg: ModelConfig, params: dict, tp: int, rank: int) -> dict:
    """The part of the full tree ``params`` that rank ``rank`` of a model
    axis of ``tp`` holds (every leaf a plain local tensor)."""
    sh = shard_geometry(cfg, tp, rank)
    specs = _trim(param_pspecs(cfg), params)

    def walk(tree, spec, name):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], k if name in ("", "layers") else name)
                    for k, v in tree.items()}
        return _slice_leaf(tree, spec, name, sh, cfg.head_dim)

    return walk(params, specs, "")


def shard_params(cfg: ModelConfig, mesh, params: dict) -> dict:
    """This rank's part of the full parameter tree (validates the split)."""
    return local_params(cfg, params, axis_size(mesh, "model"), axis_rank(mesh, "model"))


def local_cache(cache, Hkv_full: int, tp: int, rank: int):
    """The part of a full cache (dense, int4 or hybrid) that rank ``rank``
    of a model axis of ``tp`` holds: every field with "model" in
    ``_CACHE_FIELD_SPECS`` cut to the rank's kv heads (a kv head shared by
    ``tp / Hkv`` ranks where "model" exceeds the heads); a new cache, its
    counters copies."""
    Hkv_l = max(Hkv_full // tp, 1)
    kv0 = rank * Hkv_l if Hkv_full % tp == 0 else rank // (tp // Hkv_full)
    updates = {}
    for f in dataclasses.fields(cache):
        spec = _CACHE_FIELD_SPECS.get(f.name)
        v = getattr(cache, f.name)
        if spec is None or not isinstance(v, torch.Tensor):
            continue
        updates[f.name] = (_take(v, spec.index("model"), kv0, kv0 + Hkv_l).clone()
                           if "model" in spec else v.clone())
    return dataclasses.replace(cache, **updates)


def shard_cache(mesh, cache):
    """This rank's part of a full cache (dense / int4 / hybrid), with the
    head-on-"model" layout of ``_CACHE_FIELD_SPECS``."""
    Hkv = cache.lengths.shape[1]
    return local_cache(cache, Hkv, axis_size(mesh, "model"), axis_rank(mesh, "model"))


def batch_axes(mesh) -> tuple:
    """Mesh axes a batch dimension shards over: ("replica", "data") on a
    multi-slice mesh, ("data",) otherwise."""
    return ("replica", "data") if "replica" in mesh.mesh_dim_names else ("data",)


def batch_shard(mesh) -> tuple:
    """(number of batch shards, this rank's batch shard): the product of
    the batch axes and this rank's coordinate on them, replica-major."""
    n, idx = 1, 0
    for a in batch_axes(mesh):
        idx = idx * axis_size(mesh, a) + axis_rank(mesh, a)
        n *= axis_size(mesh, a)
    return n, idx


def shard_batched_cache(mesh, cache):
    """This rank's part of a batch-stacked cache (a leading batch axis on
    every tensor): the batch over ``batch_axes(mesh)`` when they divide it,
    and the kv heads over "model" per ``_CACHE_FIELD_SPECS``."""
    n, idx = batch_shard(mesh)
    tp, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")
    updates = {}
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            continue
        B = v.shape[0]
        if B % n == 0:
            v = _take(v, 0, idx * B // n, (idx + 1) * B // n)
        inner = _CACHE_FIELD_SPECS.get(f.name)
        if inner is not None and len(inner) == v.dim() - 1 and "model" in inner:
            d = inner.index("model") + 1
            per = v.shape[d] // tp
            v = _take(v, d, rank * per, (rank + 1) * per)
        updates[f.name] = v
    out = object.__new__(type(cache))
    out.__dict__.update({**cache.__dict__, **updates})
    return out
