"""The port stands alone: it imports neither JAX nor the reference package
(nor ``safetensors`` or ``ml_dtypes``, which the card's machine lacks), and
its engine runs on the card unless the caller asks for the CPU."""

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
            "kvzip_tpu_torch.ops.pool_decode, kvzip_tpu_torch.ops.flash_int4, "
            "kvzip_tpu_torch.ops.quant, kvzip_tpu_torch.ops.w4a8, "
            "kvzip_tpu_torch.ops.w4a8_v2, kvzip_tpu_torch.ops.fused_act, "
            "kvzip_tpu_torch.ops.windowed_attend, kvzip_tpu_torch.ops.flat_decode, "
            "kvzip_tpu_torch.ops.w4a8_fused, "
            "kvzip_tpu_torch.cache, kvzip_tpu_torch.models.params, "
            "kvzip_tpu_torch.models.transformer, kvzip_tpu_torch.serving\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'kvzip_tpu' or m.startswith('kvzip_tpu.')"
            " or m.split('.')[0] in ('safetensors', 'ml_dtypes')]\n"
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


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py"))
    + ["chip_smoke.py"])
def test_no_file_imports_safetensors_or_ml_dtypes(path):
    """The card's machine has neither: the port reads checkpoints with its
    own reader (``models/params.py::_read_raw``) and the smoke writes them
    with its own writer."""
    for mod in _imported_modules(os.path.join(ROOT, path)):
        assert mod.split(".")[0] not in ("safetensors", "ml_dtypes"), f"{path}: {mod}"


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


def test_quantized_kernel_wrappers_check_dtypes():
    """The int4 and W4A8 wrappers' argument check: packed rows must be
    uint8, scales of the stated float type, everything contiguous; a
    wrong dtype raises before any launch."""
    from kvzip_tpu_torch.ops import check_kernel_args

    q = torch.zeros((4, 8, 128), dtype=torch.bfloat16)
    packed = torch.zeros((2, 16, 64), dtype=torch.uint8)
    scales = torch.zeros((2, 16), dtype=torch.bfloat16)
    check_kernel_args("k", dict(q=q), None,
                      dict(k_q=(packed, torch.uint8), k_s=(scales, torch.bfloat16)))
    with pytest.raises(TypeError, match="uint8"):
        check_kernel_args("k", dict(q=q), None,
                          dict(k_q=(packed.to(torch.int8), torch.uint8)))
    with pytest.raises(TypeError, match="float32"):
        check_kernel_args("k", {}, None, dict(k_s=(scales, torch.float32)))
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_args("k", {}, None,
                          dict(k_q=(packed.transpose(1, 2), torch.uint8)))
