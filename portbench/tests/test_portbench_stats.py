"""The end-to-end statistics: a rate is taken over every unit of the whole
window (which closes at the end of the block in flight when time runs out)
and over all its seconds; the 95th percentile over every query, a failed
one counted as missing."""

import time
import types

import numpy as np
import pytest

from portbench import tracing
from portbench.harness import percentile
from portbench.kinds import ingest, serve
from portbench.traffic import ingest as ingest_gen
from portbench.traffic import serve as serve_gen


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile(v[:20], 95) == 19
    assert percentile([5.0], 95) == 5.0
    assert serve._p95([1.0] * 9, 1) == float("inf")
    assert serve._p95([1.0] * 39, 1) == 1.0


def _cell(kind_params, gen, seconds):
    return types.SimpleNamespace(
        traffic=kind_params, plan=gen.Plan(kind_params, 5, 512), seconds=seconds, trace=False,
        tracer=tracing.Tracer(False, "cpu"), family="qwen2", engine=object(), states=[0, 1, 2, 3],
        seed=5)


def test_serve_rate_over_whole_window(monkeypatch):
    from kvzip_tpu_torch import serving

    lat = []

    def fake(engine, qs, sts, max_new_tokens):
        t = 0.02 + 0.01 * (max_new_tokens % 3)
        lat.append(t)
        time.sleep(t)
        return [np.arange(max_new_tokens) for _ in qs]

    monkeypatch.setattr(serving, "batched_generate_ids", fake)
    p = {"documents": 4, "doc_length": 64, "clients": 8, "query_tokens": [4, 12],
         "answer_tokens": [32, 128], "trace_units": [0, 1]}
    t0 = time.perf_counter()
    out = serve.window(_cell(p, serve_gen, 0.3))
    wall = time.perf_counter() - t0
    n = len(out["requests"])
    assert n == 8 * len(lat) and sum(lat) >= 0.3 and len(lat) % 8 == 0
    tokens = sum(len(a) for _, _, a in out["requests"])
    rate = out["metrics"]["decode_tok_s"]
    assert tokens / wall <= rate <= tokens / sum(lat)
    assert out["metrics"]["query_p95_ms"] == pytest.approx(1e3 * sorted(lat)[-1], rel=0.3)


def test_ingest_rate_counts_the_block_in_flight(monkeypatch):
    calls = []

    def fake_doc(cell, doc, u, keep):
        time.sleep(0.05)
        calls.append(len(doc["ctx"]))
        return {"ctx": len(doc["ctx"]), "score": None}

    monkeypatch.setattr(ingest, "_doc", fake_doc)
    p = {"doc_lengths": [10, 20, 30, 40, 50], "queries_per_doc": 2, "query_tokens": [2, 4],
         "answer_tokens": 3, "trace_units": [0, 5]}
    out = ingest.window(_cell(p, ingest_gen, 0.12))
    # time ran out in the third document: the window closes at the block's end
    assert sorted(calls) == [10, 20, 30, 40, 50] and out["attempted"] == 5
    assert out["metrics"]["ingest_tok_s"] == pytest.approx(sum(calls) / 0.25, rel=0.25)
