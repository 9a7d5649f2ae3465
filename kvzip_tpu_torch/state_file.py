"""State files of the port: a pruned pool saved by ``Engine.save_state`` and
read back by ``Engine.load_state``, and the converter of a ``kvzip_tpu``
state file into this format.

A state file is ``<base>.npz`` (the pool's arrays, bfloat16 stored as its
uint16 bits, since numpy has no bfloat16) beside ``<base>.json`` (the
cache class, its ``align`` and ``max_rows``, the state's bookkeeping and
each array's dtype). The port's file holds the pool's fields as the port
lays them out (K row-major ``(P, D)``, packed int4 rows ``(P, D//2)``,
float32 scales ``(P,)``, 64-row segments) and its device counters
``tail_lens`` (Hkv,) and ``seen``.

The reference's file (``kvzip_tpu/engine.py::save_state``) holds K
transposed ``(D, P)``, packed int4 rows ``(D//2, P)`` for K and V, rows
``(1, P)`` for scales, zeros and ``row_head``, one ``tail_len`` and
segments of 128-65,536 rows. :func:`convert_reference_state` rewrites it
with numpy alone.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

FORMAT = "kvzip_tpu_torch pool state 1"
# the arrays laid out one row a pool row, by cache class
_ROW_FIELDS = {"PoolKV": ("k_pool", "v_pool", "row_head"),
               "PoolInt4KV": ("k_pool_q", "v_pool_q", "k_pool_s", "k_pool_z",
                              "v_pool_s", "v_pool_z", "row_head")}


def base_path(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def write(path: str, arrays: Dict[str, np.ndarray], dtypes: Dict[str, str],
          meta: dict) -> str:
    """``arrays`` (bfloat16 ones already as uint16 bits) to ``<base>.npz``,
    ``meta`` with the format and ``array_dtypes`` to ``<base>.json``;
    returns the npz path."""
    base = base_path(path)
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(dict(meta, format=FORMAT, array_dtypes=dtypes), f)
    return base + ".npz"


def read(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays as stored, meta) of a port state file; a file of another
    format raises (convert a reference file first)."""
    base = base_path(path)
    with open(base + ".json") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{base}.json is not a {FORMAT!r} file (a kvzip_tpu state file "
                         "converts with state_file.convert_reference_state)")
    with np.load(base + ".npz") as data:
        return {k: data[k] for k in data.files}, meta


def convert_reference_state(src: str, dst: str) -> str:
    """Rewrite a ``kvzip_tpu`` pool state file as the port's, with numpy:
    bfloat16 arrays keep their uint16 bits; K ``(D, P)`` and packed int4
    rows ``(D//2, P)`` become row-major; ``(1, P)`` rows become ``(P,)``;
    each layer's live rows move from the reference's segments to the
    port's (``pool.plan_offsets`` at ``pool.POOL_ALIGN`` rows, padding
    rows zero with ``row_head`` -1); ``tail_len`` becomes ``tail_lens``
    (Hkv,). Returns the new npz path."""
    from kvzip_tpu_torch.pool import POOL_ALIGN, plan_offsets

    base = base_path(src)
    with open(base + ".json") as f:
        meta = json.load(f)
    kind = meta["kind"]
    dtypes = dict(meta.get("array_dtypes", {}))
    with np.load(base + ".npz") as data:
        ref = {k: data[k] for k in data.files}
    rows = ref["layer_rows"].astype(np.int64)
    off = ref["layer_off"].astype(np.int64)
    new_off, alloc, max_rows = plan_offsets(rows, POOL_ALIGN)
    out = {}
    for f in _ROW_FIELDS[kind]:
        a = ref[f]
        # the reference's (W, P) arrays hold a pool row a column; V rows
        # of the bf16 pool are (P, D) already
        a = a[0] if a.shape[0] == 1 else (a if f == "v_pool" else a.T)
        dst_a = np.full((alloc, *a.shape[1:]), -1 if f == "row_head" else 0, a.dtype)
        for l in range(len(rows)):
            n = int(rows[l])
            dst_a[new_off[l]:new_off[l] + n] = a[off[l]:off[l] + n]
        out[f] = dst_a
    H = ref["k_tail"].shape[1]
    out.update(layer_off=new_off, layer_rows=rows.astype(np.int32), k_tail=ref["k_tail"],
               v_tail=ref["v_tail"], lengths=ref["lengths"].astype(np.int32),
               tail_lens=np.full((H,), int(ref["tail_len"]), np.int32),
               seen=np.asarray(int(ref["seen"]), np.int32))
    dtypes = {k: dtypes.get(k, str(v.dtype)) for k, v in out.items()}
    keep = ("model", "kv_type", "sink", "ctx_len", "prefill_len", "dtype")
    return write(dst, out, dtypes, dict({k: meta[k] for k in keep}, kind=kind,
                                        align=POOL_ALIGN, max_rows=max_rows))
