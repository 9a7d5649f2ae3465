"""The port's command line (``python -m kvzip_tpu_torch.cli``) on the CPU
(``KVZIP_PLATFORM=cpu``), against ``kvzip_tpu.cli``.

Held: every subcommand takes the reference's arguments (names, defaults,
choices, types); the ``--canary`` sweep's ``parse`` table reads 100.00
at ratio 1.00 and does not rise as the ratio falls;
``test`` runs and saves head scores; ``demo`` prints its JSON line, and
its baseline reports the card's out-of-memory error and lets every other
error through; ``--tp`` above 1 outside N ranks and a missing card raise. One comparison
of the two command lines: ``eval`` on a tiny checkpoint directory that
both packages load (the same weights, the same byte tokenizer: with no
tokenizer files both fall back to it) writes the same result file (9 ratio
rows), text for text, and ``parse`` prints the same table. The command lines build their engines with the engine's defaults;
here both packages' ``Engine`` take CPU-sized scoring windows, capacity
steps and answers (``SMALL``), so that a sweep costs seconds.
"""

import json
import os

import numpy as np
import pytest
import torch

from kvzip_tpu import cli as jcli
from kvzip_tpu import engine as jengine_module
from kvzip_tpu_torch import cli
from kvzip_tpu_torch import engine as engine_module
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.tokenizer import ByteTokenizer

from test_torch_engine import one_torch_thread  # noqa: F401

DEMO_TEXT = ("Tiny demo context. The maximum number of tokens per cache page is 256, "
             "and quantized layers support 2 to 8 bits. " + "filler " * 40)


SMALL = dict(score_chunk_size=256, capacity_granularity=256, max_new_tokens=16,
             decode_budget=160)


def _small(cls, **extra):
    """``cls`` with CPU-sized defaults; what a caller passes still wins."""
    class Small(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**SMALL, **extra, **kw})
    return Small


@pytest.fixture
def cpu_run(tmp_path, monkeypatch):
    """A working directory of its own, the CPU, no network; the port's
    engines CPU-sized, float32 where the command line sets no dtype (the
    demo), with the byte tokenizer ``load_tokenizer`` falls back to here
    (without importing ``transformers``)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KVZIP_PLATFORM", "cpu")
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(engine_module, "Engine", _small(Engine, tokenizer=ByteTokenizer(512),
                                                        dtype=torch.float32))
    return tmp_path


def _actions(parser, cmd):
    sub = next(a for a in parser._actions if a.dest == "cmd").choices[cmd]
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs)
            for a in sub._actions}


@pytest.mark.parametrize("cmd", ["test", "eval", "demo", "parse"])
def test_parser_takes_the_reference_arguments(cmd):
    assert _actions(cli.build_parser(), cmd) == _actions(jcli.build_parser(), cmd)


def _table(out: str) -> dict:
    rows = out.split("ratio avg_performance\n")[1].strip().splitlines()
    return {float(r.split()[0]): float(r.split()[1]) for r in rows}


def test_canary_parse_and_test_on_the_cpu(cpu_run, capsys):
    cli.main(["eval", "-m", "tiny-llama", "-d", "needle", "--num", "1", "--dtype", "float32",
              "--canary"])
    assert (cpu_run / "results" / "needle" / "0_tiny-llama__canary" / "output-pair.json").exists()
    capsys.readouterr()
    # the reference's parse globs on the model name: a tagged sweep is read
    # back as the model name plus the tag's folder suffix
    cli.main(["parse", "-m", "tiny-llama__canary", "-d", "needle"])
    table = _table(capsys.readouterr().out)
    scores = [table[r] for r in sorted(table, reverse=True)]
    assert scores[0] == 100.0 and scores == sorted(scores, reverse=True)

    cli.main(["test", "-m", "tiny-llama", "-d", "gsm", "--dtype", "float32",
              "--save_head_score"])
    out = capsys.readouterr().out
    assert "synthetic stand-in" in out and "generation at ratio 0.3" in out
    assert (cpu_run / "head_score" / "tiny-llama-gsm-0.npz").exists()


def _demo(path, *extra):
    cli.main(["demo", "--model", "tiny-llama", "--context_file", str(path), "-m", "kvzip",
              "--decode_tokens", "8", *extra])


def test_demo_on_the_cpu(cpu_run, capsys, monkeypatch):
    path = cpu_run / "ctx.txt"
    path.write_text(DEMO_TEXT)
    _demo(path, "--baseline")
    out = capsys.readouterr().out
    assert "After Compression (ratio=0.3)" in out and "Ground-truth: 256" in out
    demo = json.loads(out.strip().splitlines()[-1])["demo"]
    assert demo["pruned_gb"] <= demo["full_gb_dense"] and demo["ms_tok_full"] > 0

    # the baseline reports the card's out-of-memory error, and nothing else
    path.write_text(DEMO_TEXT[:120])

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("no room")
    for name in ("synthetic_full_pool_state", "synthetic_full_flat_state"):
        monkeypatch.setattr(engine_module.Engine, name, oom)
    _demo(path, "--baseline")
    out = capsys.readouterr().out
    assert "full-cache baseline unavailable (OutOfMemoryError)" in out
    assert "ms_tok_full" not in json.loads(out.strip().splitlines()[-1])["demo"]

    def broken(*a, **kw):
        raise RuntimeError("a kernel failed")
    for name in ("synthetic_full_pool_state", "synthetic_full_flat_state"):
        monkeypatch.setattr(engine_module.Engine, name, broken)
    with pytest.raises(RuntimeError, match="a kernel failed"):
        _demo(path, "--baseline")


def test_card_and_tp_checks(monkeypatch):
    """Without KVZIP_PLATFORM=cpu the engine asks for the card (and raises
    where there is none); ``--tp`` above 1 runs one process a rank, so in
    a process that is not one of N ranks it raises and names the torchrun
    command (``tests/test_torch_parallel_serving.py`` runs it in two)."""
    monkeypatch.delenv("KVZIP_PLATFORM", raising=False)
    assert cli.device() == "cuda"
    monkeypatch.setenv("KVZIP_PLATFORM", "cpu")
    assert cli.device() == "cpu"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = cli.build_parser().parse_args(["eval", "--tp", "2"])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.make_engine(args)
    if not torch.cuda.is_available():
        monkeypatch.delenv("KVZIP_PLATFORM")
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.make_engine(cli.build_parser().parse_args(["eval", "-m", "tiny-llama"]))


CKPT = dict(model_type="llama", vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-6,
            tie_word_embeddings=False, hidden_act="silu")


def _write_checkpoint(path) -> None:
    """A tiny llama in HuggingFace's names, float32, one shard (written with
    ``safetensors.numpy``; no tokenizer files)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    D, I, V, L = 128, 256, 256, 2
    kv = 2 * D // 4
    shapes = {"self_attn.q_proj.weight": (D, D), "self_attn.k_proj.weight": (kv, D),
              "self_attn.v_proj.weight": (kv, D), "self_attn.o_proj.weight": (D, D),
              "mlp.gate_proj.weight": (I, D), "mlp.up_proj.weight": (I, D),
              "mlp.down_proj.weight": (D, I), "input_layernorm.weight": (D,),
              "post_attention_layernorm.weight": (D,)}
    t = {"model.embed_tokens.weight": rng.standard_normal((V, D)) * 0.5,
         "model.norm.weight": 1 + 0.1 * rng.standard_normal(D),
         "lm_head.weight": rng.standard_normal((V, D)) * 0.5}
    for l in range(L):
        for k, shape in shapes.items():
            t[f"model.layers.{l}.{k}"] = (1.0 + 0.1 * rng.standard_normal(shape) if "norm" in k
                                          else 0.3 * rng.standard_normal(shape))
    os.makedirs(path)
    save_file({k: v.astype(np.float32) for k, v in t.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(CKPT, f)


def test_eval_and_parse_match_the_reference_cli(tmp_path, monkeypatch, capsys):
    """``eval`` then ``parse`` by each package in a directory of its own:
    the same result file, text for text, and the same ratio table."""
    ckpt = str(tmp_path / "tiny-ckpt")
    _write_checkpoint(ckpt)
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    # the byte tokenizer both packages fall back to here, given directly
    # (without importing ``transformers``)
    tok = dict(tokenizer=ByteTokenizer(CKPT["vocab_size"]))
    monkeypatch.setattr(engine_module, "Engine", _small(Engine, **tok))
    monkeypatch.setattr(jengine_module, "Engine", _small(jengine_module.Engine, **tok))
    files, tables = {}, {}
    for name, main in (("port", cli.main), ("ref", jcli.main)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        if name == "port":
            monkeypatch.setenv("KVZIP_PLATFORM", "cpu")
        else:
            monkeypatch.delenv("KVZIP_PLATFORM")
        main(["eval", "-m", ckpt, "-d", "needle", "--num", "1", "--dtype", "float32"])
        with open(tmp_path / name / "results" / "needle" / "0_tiny-ckpt" / "output-pair.json") as f:
            files[name] = f.read()
        capsys.readouterr()
        main(["parse", "-m", "tiny-ckpt", "-d", "needle"])
        tables[name] = capsys.readouterr().out
    assert files["port"] == files["ref"]
    rows = json.loads(files["port"])["qa"]
    assert [r[0][0] for r in rows] == cli.set_ratios("x")
    assert len({r[1]["pruned"] for r in rows}) > 1
    assert tables["port"] == tables["ref"]
    assert sorted(_table(tables["port"])) == sorted(cli.set_ratios("x", include_full=True))
