"""The ``ingest`` kind: documents one at a time, each prefilled
(``Engine.prefill(..., do_score=False)``), scored (``Engine.scoring``),
pruned (``Engine.prune``) and then asked its queries
(``Engine.generate_ids``). The window closes at the end of the block of
documents in flight once ``seconds`` have passed (a block holds each
length once, so every window holds the same mix); ``ingest_tok_s`` is the
context tokens of every document finished over the whole window's
seconds."""

from __future__ import annotations

import time

import numpy as np

from portbench.reference.prompts import query_ids


def _doc(cell, doc: dict, u: int, keep_score: bool) -> dict:
    eng, tr, traffic = cell.engine, cell.tracer, cell.traffic
    names = {p: f"u{u}:{p}" for p in ("unit", "prefill", "scoring", "prune")}
    unit = {"ctx": len(doc["ctx"]), "spans": names, "queries": [], "answers": [], "seqs": []}
    with tr.span(names["unit"]):
        with tr.span(names["prefill"]):
            st = eng.prefill(doc["ctx"], do_score=False)
        with tr.span(names["scoring"]):
            eng.scoring(st, st.ctx_ids)
        score = st.score
        with tr.span(names["prune"]):
            eng.prune(st, traffic["ratio"], traffic["level"])
        for j, body in enumerate(doc["queries"]):
            q = query_ids(cell.family, body)
            names[f"query{j}"] = f"u{u}:query{j}"
            with tr.span(names[f"query{j}"]):
                a = eng.generate_ids(q, st, max_new_tokens=doc["answer"])
            unit["seqs"].append(q)
            unit["queries"].append(len(q))
            unit["answers"].append(np.asarray(a, np.int64))
    unit.update(P=st.prefill_len, sink=st.sink)
    if tr.active:
        unit["layer_rows"] = st.cache.layer_rows.tolist()
    unit["score"] = score if keep_score else None
    return unit


def setup(cell) -> None:
    w = cell.plan.warmup()
    _doc(cell, {"ctx": w["ctx"], "queries": w["queries"], "answer": w["answer"]}, -1, False)


def window(cell) -> dict:
    lo, hi = cell.traffic["trace_units"]
    units, docs = [], []
    failed = attempted = 0
    t0 = time.perf_counter()
    u = 0
    while True:
        if cell.trace and u == lo:
            cell.tracer.begin()
        doc = cell.plan.next_doc()
        attempted += 1
        try:
            units.append(_doc(cell, doc, u, True))
            docs.append(doc)
        except Exception as exc:  # a document that raises is failed, and ends the window
            failed += 1
            print(f"document {u} failed: {exc!r}", flush=True, file=__import__("sys").stderr)
            break
        u += 1
        if u == hi:
            cell.tracer.end()
        if (time.perf_counter() - t0 >= cell.seconds and not cell.tracer.active
                and u % len(cell.traffic["doc_lengths"]) == 0):
            break
    elapsed = time.perf_counter() - t0
    cell.tracer.end()
    ctx = sum(x["ctx"] for x in units)
    out = {"attempted": attempted, "failed": failed, "units": units, "docs": docs,
           "metrics": {"ingest_tok_s": ctx / elapsed},
           "notes": {"documents": f"{len(units)} finished, {ctx} context tokens in {elapsed:.3f} s"}}
    if cell.trace:
        out["record"] = {"units": units[lo:hi], "spans": cell.tracer.spans, "ops": cell.tracer.ops}
    return out


def sample(cell, out: dict) -> list:
    """The longest document finished and ``check_docs - 1`` others drawn
    from the seed, each with every query it answered; the program's scores
    of those documents, moved to the host."""
    units = out["units"]
    if not units:
        return []
    rng = np.random.default_rng([cell.seed, 5])
    longest = int(np.argmax([x["ctx"] for x in units]))
    rest = [i for i in range(len(units)) if i != longest]
    pick = [longest] + [int(i) for i in rng.permutation(rest)[:cell.traffic["check_docs"] - 1]]
    docs = []
    for i in pick:
        x = units[i]
        docs.append(dict(ctx=out["docs"][i]["ctx"],
                         seqs=[np.concatenate([q, a[:-1]]) for q, a in zip(x["seqs"], x["answers"])
                               if len(a)],
                         first=[len(q) - 1 for q, a in zip(x["seqs"], x["answers"]) if len(a)],
                         served=[a for a in x["answers"] if len(a)],
                         score=x["score"].float().cpu()))
    for x in units:
        x["score"] = None
    return docs
