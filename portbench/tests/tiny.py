"""A cell at a size a CPU test holds: the configuration's family and
formats at tiny widths (head_dim 128, so the program builds its pool;
weights of std 0.08, about 1 / sqrt(hidden), so that answers depend on
their queries as at full width),
documents of 1,200-2,600 tokens (two scoring chunks), float32 on the CPU,
the program running its plain versions."""

import time

import torch

from portbench.harness import load_json, run_cell

TINY = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=128, vocab_size=512,
            rms_norm_eps=1e-6, rope_theta=10000, rope_scaling=None, tie_word_embeddings=False,
            init_std=0.08)
INGEST = {"doc_lengths": [1200, 2600], "query_tokens": [4, 12], "answer_tokens": 6,
          "warmup_doc": 600, "trace_units": [0, 2], "check_docs": 2,
          "score_chunks": 3}
SERVE = {"documents": 2, "doc_length": 1500, "clients": 3, "query_tokens": [4, 12],
         "answer_tokens": [4, 10], "trace_units": [1, 2], "check_docs": 2, "check_requests": 6,
         "score_chunks": 3}


def tiny_run(root: str, workload: str, seed: int = 2 ** 31 + 17, controls: bool = False,
             trace: bool = False, seconds: float = 1.0) -> dict:
    from kvzip_tpu_torch.config import tiny_config

    bench = load_json(root, "BENCHMARK.json")
    spec = {w["name"]: w for w in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    model = {**load_json(root, conf["file"])["model"], **TINY}
    fam = model["family"]
    cfg = tiny_config(fam, head_dim=128, num_heads=4, num_kv_heads=2, num_layers=2)
    traffic = INGEST if workload.endswith(".ingest") else SERVE
    return run_cell(bench, workload, seed, seconds, trace, time.time(), device="cpu",
                    dtype=torch.float32, controls=controls, preset_config=cfg,
                    overrides={"config": {"model": model}, "traffic": traffic})
