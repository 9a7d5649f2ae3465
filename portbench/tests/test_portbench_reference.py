"""The plain reference agrees with the program's CPU path at a tiny size,
in every configuration's formats and traffic kind; the control (the
reference one precision step below the configuration's) does not, by
limits of the test size; and a run whose timed path is broken underneath comes
out not correct: a decode step that leaves its state unchanged, half of a
batch left out (its queries unanswered, or given another's answer), a token
altered where it is produced."""

import json
import os

import numpy as np
import pytest

from portbench.tests.tiny import tiny_run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def limits(workload, where=("portbench", "limits")):
    with open(os.path.join(ROOT, *where, workload + ".json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def passes(readings, lim, prefix=""):
    return all(readings[prefix + k] <= v for k, v in lim.items())


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_and_control_fails(workload):
    """The program holds the cell's limits at the test size. The control
    fails the limits of the test size (``tests/limits/``), which the
    program holds: its own limits are set from chip readings at the
    cell's size, where its errors have grown through every layer."""
    r = tiny_run(ROOT, workload, controls=True)
    rd = r["readings"]
    assert r["correct"], rd
    assert rd["requests"] > 0 and rd["tokens"] > 0
    assert passes(rd, limits(workload))
    tiny = limits(workload, ("portbench", "tests", "limits"))
    assert passes(rd, tiny), (rd, tiny)
    assert not passes(rd, tiny, "control_"), (rd, tiny)


def _stuck_steps(monkeypatch):
    """Decode steps that leave the state unchanged: the step index moves,
    the last token is written again, nothing is forwarded."""
    from kvzip_tpu_torch import engine, serving

    def stuck(self, running):
        self.tokens.index_copy_(0, self.i + 1, self.tokens.index_select(0, self.i))
        self.i += running

    monkeypatch.setattr(engine.DecodeStep, "step",
                        lambda self: stuck(self, (self.done == 0) & (self.i < self.budget)))
    monkeypatch.setattr(serving.MergedDecodeStep, "step",
                        lambda self: stuck(self, (self.done == 0).any() & (self.i < self.budget)))


def _half_batch(monkeypatch):
    """Half of each batch left out: a merged batch returns the first half's
    answers only; in ``ingest``, where a document's queries are its batch,
    the second query gets the first one's answer."""
    from kvzip_tpu_torch import engine, serving

    orig_b = serving.batched_generate_ids

    def half(eng, qs, sts, max_new_tokens=None):
        k = max(1, len(qs) // 2)
        return orig_b(eng, qs[:k], sts[:k], max_new_tokens=max_new_tokens)

    monkeypatch.setattr(serving, "batched_generate_ids", half)
    orig_g = engine.Engine.generate_ids
    last = {}

    def gen(self, q, st, update_cache=False, max_new_tokens=None):
        if id(st) in last:
            return last.pop(id(st))
        a = orig_g(self, q, st, update_cache, max_new_tokens)
        last[id(st)] = a
        return a

    monkeypatch.setattr(engine.Engine, "generate_ids", gen)


def _altered_token(monkeypatch):
    """One token of every answer changed where it is produced."""
    from kvzip_tpu_torch import engine, serving

    def alter(a):
        a = np.array(a, copy=True)
        if len(a) > 1:
            a[len(a) // 2] = (a[len(a) // 2] + 1) % 256
        return a

    orig_b, orig_g = serving.batched_generate_ids, engine.Engine.generate_ids
    monkeypatch.setattr(serving, "batched_generate_ids",
                        lambda *a, **k: [alter(x) for x in orig_b(*a, **k)])
    monkeypatch.setattr(engine.Engine, "generate_ids",
                        lambda self, *a, **k: alter(orig_g(self, *a, **k)))


@pytest.mark.parametrize("fault", [_stuck_steps, _half_batch, _altered_token])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, fault, workload):
    """Judged by the limits of the test size, which the unbroken program
    holds (``test_reference_agrees_and_control_fails``)."""
    fault(monkeypatch)
    r = tiny_run(ROOT, workload)
    tiny = limits(workload, ("portbench", "tests", "limits"))
    assert r["failed"] > 0 or not passes(r["readings"], tiny), r["readings"]
    assert not r["correct"]
