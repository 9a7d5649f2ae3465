"""The port stands alone: it imports neither JAX nor the reference package
(nor ``safetensors``, ``ml_dtypes`` or ``cffi``, which the card's machine
lacks), its command line and harness import without the optional
packages that machine lacks too, and its engine runs on the card unless
the caller asks for the CPU."""

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
            "kvzip_tpu_torch.models.transformer, kvzip_tpu_torch.models.hybrid, "
            "kvzip_tpu_torch.serving, kvzip_tpu_torch.parallel, "
            "kvzip_tpu_torch.parallel.mesh, kvzip_tpu_torch.parallel.collectives, "
            "kvzip_tpu_torch.parallel.pool_tp, kvzip_tpu_torch.parallel.ring_prefill, "
            "kvzip_tpu_torch.parallel.dryrun, "
            "kvzip_tpu_torch.cli, kvzip_tpu_torch.native, kvzip_tpu_torch.data.loaders, "
            "kvzip_tpu_torch.data.needle, kvzip_tpu_torch.data.wrapper, "
            "kvzip_tpu_torch.eval.metrics, kvzip_tpu_torch.eval.repoqa, "
            "kvzip_tpu_torch.eval.evaluator, kvzip_tpu_torch.eval.needle_viz, "
            "kvzip_tpu_torch.utils.io, kvzip_tpu_torch.utils.profiling\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'kvzip_tpu' or m.startswith('kvzip_tpu.')"
            " or m.split('.')[0] in ('safetensors', 'ml_dtypes', 'cffi')]\n"
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
    """The card's machine has none of them: the port reads checkpoints with
    its own reader (``models/params.py::_read_raw``), the smoke writes them
    with its own writer, and ``native.py`` binds the metrics library with
    ``ctypes`` (the reference: ``cffi``)."""
    for mod in _imported_modules(os.path.join(ROOT, path)):
        assert mod.split(".")[0] not in ("safetensors", "ml_dtypes", "cffi"), f"{path}: {mod}"


def test_cli_and_harness_run_without_the_optional_packages():
    """With ``rouge``, ``nltk``, ``datasets``, ``matplotlib``, ``cffi`` and
    ``transformers`` hidden (the card's machine has none of them), the
    command line and the harness import, the datasets fall back to their
    stand-ins, and the scores come from the native library."""
    code = (
        "import sys\n"
        "class Hide:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('rouge', 'nltk', 'datasets', 'matplotlib',"
        " 'cffi', 'transformers'):\n"
        "            raise ImportError(name + ' hidden')\n"
        "sys.meta_path.insert(0, Hide())\n"
        "from kvzip_tpu_torch import cli, native\n"
        "from kvzip_tpu_torch.data import load_dataset_all\n"
        "from kvzip_tpu_torch.eval.metrics import evaluate_answer\n"
        "from kvzip_tpu_torch.eval.repoqa import compute_function_similarity\n"
        "from kvzip_tpu_torch.tokenizer import load_tokenizer\n"
        "cli.build_parser().parse_args(['demo', '--ctx_tokens', '16'])\n"
        "assert type(load_tokenizer('llama3.2-3b')).__name__ == 'ByteTokenizer'\n"
        "assert load_dataset_all('squad', None, n_data=2)\n"
        "assert evaluate_answer(['a b c d'], ['a b x d'], 'squad', 'summarize') == [0.75]\n"
        "src = 'def f ( x ) : return x + 1'\n"
        "assert compute_function_similarity(src, src) > 0.99\n"
        "assert native._lib is not None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip().endswith("ok")


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


@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen3-4b", "qwen3-8b", "qwen3-14b",
                                  "qwen3-32b", "gemma3-1b", "gemma3-4b", "gemma3-12b",
                                  "gemma3-27b"])
def test_qwen3_and_gemma3_presets_build(name):
    """Every qwen3 and gemma3 preset resolves and its cache builds (on the
    meta device: shapes, no memory); a gemma3 preset is a hybrid whose
    rings hold the window rounded up to 128 rows, and its tiny config's
    engine builds on the CPU as a retain engine (the family's forward
    pieces are held against the reference in test_torch_families.py)."""
    from kvzip_tpu_torch.cache import HybridKV, init_cache, init_hybrid_cache
    from kvzip_tpu_torch.config import resolve_config, tiny_config
    from kvzip_tpu_torch.engine import Engine

    cfg = resolve_config(name)
    family = name.split("-")[0]
    assert cfg.family == family and cfg.qk_norm
    if family == "gemma3":
        cache = init_hybrid_cache(cfg, 4096, device="meta")
        assert isinstance(cache, HybridKV)
        W = {"gemma3-1b": 512}.get(name, 1024)
        L_t = len(cfg.static_layer_ids)
        assert cache.k_ring.shape == (cfg.num_layers - L_t, cfg.num_kv_heads, W, cfg.head_dim)
        assert cache.k_static.shape == (L_t, cfg.num_kv_heads, 4096, cfg.head_dim)
        if name == "gemma3-4b":
            assert cfg.static_layer_ids == (5, 11, 17, 23, 29)
    else:
        assert init_cache(cfg, 4096, device="meta").k.shape[0] == cfg.num_layers
    eng = Engine(f"tiny-{family}", config=tiny_config(family), device="cpu",
                 dtype=torch.float32, kv_type="evict")
    assert eng.kv_type == ("retain" if family == "gemma3" else "evict")


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
