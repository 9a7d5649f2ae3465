"""The port stands alone: it imports neither JAX nor the reference package,
and its engine runs on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "kvzip_tpu_torch")


def test_import_loads_no_jax_and_no_reference():
    code = ("import sys, kvzip_tpu_torch.engine, kvzip_tpu_torch.ops.flash, "
            "kvzip_tpu_torch.ops.score_kernel, "
            "kvzip_tpu_torch.ops.ragged_decode, "
            "kvzip_tpu_torch.ops.pool_decode\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'kvzip_tpu' or m.startswith('kvzip_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py"))
    + ["chip_smoke.py"])
def test_no_file_imports_jax_or_reference(path):
    for mod in _imported_modules(os.path.join(ROOT, path)):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "kvzip_tpu"), f"{path}: {mod}"


def test_engine_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from kvzip_tpu_torch.config import tiny_config
    from kvzip_tpu_torch.engine import Engine

    with pytest.raises(RuntimeError, match="CUDA"):
        Engine("tiny-llama", config=tiny_config("llama"))
    eng = Engine("tiny-llama", config=tiny_config("llama"), device="cpu",
                 dtype=torch.float32)
    assert eng.params["embed"].device.type == "cpu"


def test_kernel_wrappers_raise_on_cuda_without_kernel_inputs():
    """A wrapper never falls back: bad kernel inputs raise, and CPU inputs
    are the only way to the plain version."""
    from kvzip_tpu_torch.ops import check_kernel_args, on_cuda

    q = torch.zeros((4, 8, 128))
    assert on_cuda(q) is False
    with pytest.raises(TypeError, match="bfloat16"):
        check_kernel_args("k", dict(q=q))
    with pytest.raises(ValueError, match="head_dim"):
        check_kernel_args("k", dict(q=q[..., :64].bfloat16()))
    with pytest.raises(ValueError, match="mixed devices"):
        on_cuda(q, torch.zeros(1, device="meta"))
