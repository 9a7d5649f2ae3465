"""The port's native metrics (``kvzip_tpu_torch/native.py``: the repository's
``csrc/metrics.cpp`` built by ``g++`` and bound with ``ctypes``) against the
reference's ``cffi`` binding of the same source, on token lists drawn from
a numpy seed. Both run the same C++, so every result must be exactly
equal."""

import os

import numpy as np
import pytest

from kvzip_tpu import native as jnative
from kvzip_tpu_torch import native

FUNCS = ("lcs_length", "rouge_l_f", "sentence_bleu", "token_f1")


def _pairs(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    out = [([], []), (["a"], []), ([], ["a"]), (["x", "y"], ["x", "y"])]
    for _ in range(n):
        vocab = int(rng.integers(2, 16))
        a = [f"w{x}" for x in rng.integers(0, vocab, int(rng.integers(0, 40)))]
        b = [f"w{x}" for x in rng.integers(0, vocab, int(rng.integers(0, 40)))]
        out.append((a, b))
    return out


@pytest.mark.parametrize("name", FUNCS)
def test_native_equals_reference(name):
    for a, b in _pairs(FUNCS.index(name)):
        assert getattr(native, name)(a, b) == getattr(jnative, name)(a, b), (a, b)


def test_library_is_built_in_the_port_by_source_hash():
    """The library lands in the port's gitignored build directory under a
    name carrying the source's hash, never in the root ``csrc/``; an
    unchanged source reuses it."""
    path = native._build()
    assert os.path.dirname(path) == native._BUILD
    assert os.path.basename(path) == os.path.basename(native._lib_path())
    assert os.path.basename(path).startswith("libkvzip_metrics-")
    mtime = os.path.getmtime(path)
    assert native._build() == path and os.path.getmtime(path) == mtime
    assert native._intern(["b", "a"], ["a", "c"]) == jnative._intern(["b", "a"], ["a", "c"])
