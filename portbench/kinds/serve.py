"""The ``serve`` kind: ``documents`` documents compressed at set-up
(prefill, scoring, prune, as ``ingest`` does), then closed-loop batches of
``clients`` queries through ``serving.batched_generate_ids``, one answer
length a batch. A query's latency runs from its batch's submission to the
return of its answer ids. The window closes at the end of the block of
``clients`` batches in flight once ``seconds`` have passed (a block holds
each answer length once, so every window holds the same mix); ``decode_tok_s`` is the answer tokens
of the window over its seconds, ``query_p95_ms`` the nearest-rank 95th
percentile of every query's latency.

In a traced run the benchmark's spans also wrap the merged batch's inner
calls (``MergedBatch.__init__``, ``.ingest``, ``.decode`` and the captured
step's ``MergedDecodeStep.__init__``), unsynced, to name idle gaps and to
find the decode step's replays: after the capture (which ends in a
synchronize) to the batch's synced end. After the slice, 20 replays of its
last batch's step, answer ended, are timed with CUDA events
(``step_device_ms``), and the batches after it, unprofiled, keep their
wall time and steps (``batch_overhead_ms``)."""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench.reference.prompts import query_ids


def _compress(cell, ctx: np.ndarray):
    """A document prefilled, scored and pruned; its scores kept on the host
    for the comparison."""
    eng, traffic = cell.engine, cell.traffic
    st = eng.prefill(ctx, do_score=False)
    eng.scoring(st, st.ctx_ids)
    cell.doc_scores.append(st.score.float().cpu())
    eng.prune(st, traffic["ratio"], traffic["level"])
    return st


def setup(cell) -> None:
    from kvzip_tpu_torch import serving

    cell.docs = cell.plan.documents()
    cell.doc_scores = []
    cell.states = [_compress(cell, d) for d in cell.docs]
    w = cell.plan.warmup()
    serving.batched_generate_ids(cell.engine, [query_ids(cell.family, q) for q in w["queries"]],
                                 [cell.states[d] for d in w["docs"]], max_new_tokens=w["answer"])


@contextlib.contextmanager
def _wrapped(cell, unit: dict):
    """The merged batch's inner calls inside unsynced spans of ``unit``;
    the captured step kept in ``unit["step"]``."""
    from kvzip_tpu_torch import serving

    tr = cell.tracer
    saved = {}

    def wrap(cls, attr, part, keep_self=False):
        orig = getattr(cls, attr)
        saved[(cls, attr)] = orig

        def inner(self, *a, **kw):
            name = unit["spans"].setdefault(part, f"{unit['id']}:{part}")
            with tr.span(name, sync=False):
                r = orig(self, *a, **kw)
            if keep_self:
                unit["step"] = self
            return r
        setattr(cls, attr, inner)

    if tr.active:
        wrap(serving.MergedBatch, "__init__", "merge")
        wrap(serving.MergedBatch, "ingest", "ingest")
        wrap(serving.MergedBatch, "decode", "decode")
        wrap(serving.MergedDecodeStep, "__init__", "capture", keep_self=True)
    try:
        yield
    finally:
        for (cls, attr), orig in saved.items():
            setattr(cls, attr, orig)


def step_device_ms(step, n: int = 20) -> float:
    """Device ms of one replay of a captured step, over ``n`` replays
    between two CUDA events (the answer has ended: a replay advances
    nothing)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        step.graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _tensor_bytes(obj) -> int:
    return sum(v.numel() * v.element_size() for v in vars(obj).values()
               if isinstance(v, torch.Tensor))


def window(cell) -> dict:
    from kvzip_tpu_torch import serving

    lo, hi = cell.traffic["trace_units"]
    eng, tr = cell.engine, cell.tracer
    lat, requests, units, post = [], [], [], []
    tokens = failed = attempted = 0
    step_ms = None
    t0 = time.perf_counter()
    u = 0
    while True:
        if cell.trace and u == lo:
            tr.begin()
        b = cell.plan.next_batch()
        qs = [query_ids(cell.family, q) for q in b["queries"]]
        unit = {"id": f"u{u}", "spans": {"unit": f"u{u}:unit"}, "B": len(qs),
                "q_lens": [len(q) for q in qs], "answer": b["answer"]}
        attempted += len(qs)
        ts = time.perf_counter()
        try:
            with _wrapped(cell, unit), tr.span(unit["spans"]["unit"]):
                ans = serving.batched_generate_ids(eng, qs, [cell.states[d] for d in b["docs"]],
                                                   max_new_tokens=b["answer"])
        except Exception as exc:  # the batch's queries failed; the window ends
            failed += len(qs)
            print(f"batch {u} failed: {exc!r}", file=sys.stderr, flush=True)
            break
        ms = (time.perf_counter() - ts) * 1e3
        failed += len(qs) - len(ans)  # a query the batch returned no answer for
        lat += [ms] * len(ans)
        if cell.trace and u >= hi:
            # an unprofiled batch after the slice: its wall time and steps
            # (the budget, or the longest answer where every one ended early)
            post.append((ms, min(b["answer"] - 1, max(len(a) for a in ans))))
        for d, q, a in zip(b["docs"], qs, ans):
            requests.append((d, q, np.asarray(a, np.int64)))
            tokens += len(a)
        step = unit.pop("step", None)
        if step is not None:
            m = step.m
            unit.update(steps=int(step.steps_read), layer_rows=m.layer_rows.tolist(),
                        merged_bytes=_tensor_bytes(m))
            units.append(unit)
        u += 1
        if u == hi and tr.active:
            tr.end()
            if step is not None and step.graph is not None:
                step_ms = step_device_ms(step)
        del step
        if (time.perf_counter() - t0 >= cell.seconds and not tr.active
                and u % cell.traffic["clients"] == 0):
            break
    elapsed = time.perf_counter() - t0
    tr.end()
    out = {"attempted": attempted, "failed": failed, "requests": requests,
           "metrics": {"decode_tok_s": tokens / elapsed,
                       "query_p95_ms": _p95(lat, failed)},
           "notes": {"queries": f"{len(lat)} answered, {failed} failed, {tokens} answer "
                                f"tokens in {elapsed:.3f} s; p95 over {len(lat) + failed}"}}
    if cell.trace:
        out["record"] = {"units": units, "spans": tr.spans, "ops": tr.ops, "step_ms": step_ms,
                         "post_batches": post}
    return out


def _p95(lat: list, failed: int) -> float:
    """The 95th percentile with every failed query counted as missing (an
    infinite latency)."""
    from portbench.harness import percentile

    return percentile(lat + [float("inf")] * failed, 95) if lat or failed else float("nan")


def sample(cell, out: dict) -> list:
    """The longest answered request, and every request (at most
    ``check_requests`` in all, drawn from the seed) over its document and
    ``check_docs - 1`` others drawn from the seed."""
    reqs = out["requests"]
    cell.states = None
    if not reqs:
        return []
    rng = np.random.default_rng([cell.seed, 5])
    longest = int(np.argmax([len(a) for _, _, a in reqs]))
    others = [d for d in rng.permutation(cell.traffic["documents"]) if d != reqs[longest][0]]
    docs = [reqs[longest][0]] + [int(d) for d in others[:cell.traffic["check_docs"] - 1]]
    pool = [i for i in rng.permutation(len(reqs)) if reqs[i][0] in docs and i != longest]
    chosen = [longest] + [int(i) for i in pool[:cell.traffic["check_requests"] - 1]]
    out_docs = []
    for d in docs:
        mine = [reqs[i] for i in chosen if reqs[i][0] == d and len(reqs[i][2])]
        if not mine:
            continue
        out_docs.append(dict(ctx=cell.docs[d], seqs=[np.concatenate([q, a[:-1]]) for _, q, a in mine],
                             first=[len(q) - 1 for _, q, _ in mine],
                             served=[a for _, _, a in mine], score=cell.doc_scores[d]))
    return out_docs
