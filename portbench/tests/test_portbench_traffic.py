"""The generators give the same inputs for the same seed, every block of
documents holds each length once, and every block of batches each answer
length once."""

import json
import os

import numpy as np

from portbench.traffic import ingest, serve

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def params(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def docs(seed, n=10):
    plan = ingest.Plan(params("ingest"), seed, 151936)
    return [plan.next_doc() for _ in range(n)]


def test_ingest_same_seed_same_inputs():
    a, b = docs(2 ** 31 + 11), docs(2 ** 31 + 11)
    for x, y in zip(a, b):
        assert np.array_equal(x["ctx"], y["ctx"])
        assert all(np.array_equal(p, q) for p, q in zip(x["queries"], y["queries"]))
    c = docs(2 ** 31 + 12)
    assert any(len(x["ctx"]) != len(y["ctx"]) or not np.array_equal(x["ctx"], y["ctx"])
               for x, y in zip(a, c))


def test_ingest_blocks_of_five_lengths():
    p = params("ingest")
    for seed in (0, 7, 2 ** 31 + 5):
        d = docs(seed, 15)
        for b in range(3):
            block = d[5 * b:5 * b + 5]
            assert sorted(len(x["ctx"]) for x in block) == sorted(p["doc_lengths"])
            qlens = sorted(len(q) for x in block for q in x["queries"])
            assert qlens == sorted(np.rint(np.linspace(*p["query_tokens"], 10)).astype(int))
            assert all(x["answer"] == p["answer_tokens"] for x in block)
            assert all(int(x["ctx"].max()) < 151936 for x in block)


def test_serve_blocks_and_seed():
    p = params("serve")
    for seed in (3, 2 ** 31 + 99):
        plan = serve.Plan(p, seed, 152064)
        again = serve.Plan(p, seed, 152064)
        assert all(np.array_equal(x, y) for x, y in zip(plan.documents(), again.documents()))
        batches = [plan.next_batch() for _ in range(16)]
        same = [again.next_batch() for _ in range(16)]
        assert [b["docs"] for b in batches] == [b["docs"] for b in same]
        grid = sorted(np.rint(np.linspace(*p["answer_tokens"], p["clients"])).astype(int))
        for k in range(2):
            assert sorted(b["answer"] for b in batches[8 * k:8 * k + 8]) == grid
        for b in batches:
            assert len(b["queries"]) == p["clients"]
            assert sorted(len(q) for q in b["queries"]) == sorted(
                np.rint(np.linspace(*p["query_tokens"], p["clients"])).astype(int))
            assert all(0 <= d < p["documents"] for d in b["docs"])
