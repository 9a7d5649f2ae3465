"""Build and load the port's CUDA kernels (K1-K16).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, ``build/lib<name>-<hash>.so``, loaded through
``ctypes``. The hash covers the source and every shared header
(``csrc/*.cuh``), so an edited source or header rebuilds and an unchanged
one is reused. Nothing builds when the module is imported: the first
kernel call builds its library, and :func:`build_all` builds every library
at once, one ``nvcc`` each, all started together. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
KERNELS = ("flash", "score", "ragged_decode", "pool_decode", "flash_int4",
           "pool_decode_int4", "w4a8", "windowed_attend", "fused_act", "flat_decode",
           "flat_decode_int4", "w4a8_fused", "w4a8_v1")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str, tmp: str) -> subprocess.Popen:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=KERNELS) -> Dict[str, str]:
    """Build every missing library in parallel; returns nvcc's log per
    kernel (ptxas register and shared-memory use), kept beside each library
    (``lib<name>-<hash>.so.log``) and read back where the library is
    reused."""
    os.makedirs(BUILD, exist_ok=True)
    with _lock:
        procs = {}
        for n in names:
            out = _lib_path(n)
            if not os.path.exists(out):
                tmp = f"{out}.{os.getpid()}.tmp"
                procs[n] = (out, tmp, _start(n, tmp))
        logs = {n: "" for n in names}
        errors: List[str] = []
        for n, (out, tmp, proc) in procs.items():
            logs[n], _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{logs[n]}")
            else:
                with open(f"{out}.log", "w") as fh:
                    fh.write(logs[n])
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in procs and os.path.exists(f"{_lib_path(n)}.log"):
                with open(f"{_lib_path(n)}.log") as fh:
                    logs[n] = fh.read()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def kernel(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel library ``name``; every launcher
    returns a CUDA error code."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
