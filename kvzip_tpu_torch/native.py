"""ctypes bindings to the native metric kernels (the repository's
``csrc/metrics.cpp``).

The first call compiles the source with ``g++ -O3 -shared -fPIC`` into
``kvzip_tpu_torch/build/libkvzip_metrics-<hash>.so`` (the hash is of the
source, so an edited source rebuilds and an unchanged one is reused; the
library is written under a temporary name and moved into place, so
processes building at once do not race). All callers fall back to pure
Python when compilation is unavailable. String tokens are interned to
int32 ids before crossing the FFI boundary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "csrc", "metrics.cpp")
_BUILD = os.path.join(_HERE, "build")
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_lib = None


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"libkvzip_metrics-{digest}.so")


def _build() -> str:
    path = _lib_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    i32p = ctypes.POINTER(ctypes.c_int32)
    args = [i32p, ctypes.c_int32, i32p, ctypes.c_int32]
    for name, res in (("kvz_lcs_length", ctypes.c_int32),
                      ("kvz_rouge_l_f", ctypes.c_double),
                      ("kvz_sentence_bleu", ctypes.c_double),
                      ("kvz_token_f1", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    _lib = lib
    return _lib


def _intern(a: Sequence[str], b: Sequence[str]):
    vocab = {}
    def ids(tokens):
        out = []
        for t in tokens:
            if t not in vocab:
                vocab[t] = len(vocab)
            out.append(vocab[t])
        return out
    return ids(a), ids(b)


def _as_i32(xs: List[int]):
    return (ctypes.c_int32 * len(xs))(*xs), len(xs)


def _call(name: str, a: Sequence[str], b: Sequence[str]):
    fn = getattr(_load(), name)
    ia, ib = _intern(a, b)
    pa, na = _as_i32(ia)
    pb, nb = _as_i32(ib)
    return fn(pa, na, pb, nb)


def lcs_length(a: Sequence[str], b: Sequence[str]) -> int:
    return int(_call("kvz_lcs_length", a, b))


def rouge_l_f(pred: Sequence[str], ref: Sequence[str]) -> float:
    return float(_call("kvz_rouge_l_f", pred, ref))


def sentence_bleu(reference: Sequence[str], candidate: Sequence[str]) -> float:
    return float(_call("kvz_sentence_bleu", reference, candidate))


def token_f1(pred: Sequence[str], ref: Sequence[str]) -> float:
    return float(_call("kvz_token_f1", pred, ref))


if __name__ == "__main__":
    print("built:", _build())
