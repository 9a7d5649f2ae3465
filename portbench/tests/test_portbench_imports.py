"""The import check: a module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``kvzip_tpu`` is found, compared whole (``kvzip_tpu_torch``
is the port); and nothing the benchmark imports loads one."""

import subprocess
import sys
import types

from portbench.harness import forbidden_modules


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kvzip_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kvzip_tpu.engine", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert forbidden_modules() == ["jax.numpy", "kvzip_tpu.engine"]


def test_benchmark_loads_no_jax():
    code = ("import portbench.run, portbench.calibrate, portbench.kinds.ingest, "
            "portbench.kinds.serve, kvzip_tpu_torch.engine, kvzip_tpu_torch.serving; "
            "from portbench.harness import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=__file__.rsplit("/portbench/", 1)[0], timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
