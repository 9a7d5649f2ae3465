"""The work of a traced unit (a document of ``ingest``, a batch of
``serve``), counted from the shapes the benchmark knows: the least time of
each kernel family's part at the card's peaks (the roofline bounds) and
the model's operations at the peak of the precision each part's matmuls run
in (the whole step's share, ``mfu``).

Where matmuls run: the bf16 configuration's in bf16; the W4A8
configuration's linears in int8 below 512 rows (K8) and as a bf16 product
of the dequantized weights from 512 rows (prefill chunks, scoring, a merged
batch's query ingest), its attention in bf16. The model's operations a
token are 2 x the non-embedding parameters, plus 4 D a visible (query
head, key) pair in attention; the scores add 2 D a visible pair; padding
rows, the head and elementwise work are not counted.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.prompts import repeat_prompts
from portbench.roofline import attention, bound_s, linear

DEQUANT_ROWS = 512


def dims(rec: dict) -> tuple:
    m = rec["model"]
    return (m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"],
            m["num_hidden_layers"])


def _lin_peak(rec: dict, rows: int) -> float:
    pk = rec["peaks"]
    w4 = rec["quant"].get("weights", "none") == "w4a8"
    return pk["int8_ops"] if w4 and rows < DEQUANT_ROWS else pk["bf16_flops"]


def _int4(rec: dict) -> bool:
    return rec["quant"].get("kv", "none") == "int4"


def chunks(rec: dict, u: dict) -> list:
    """(repeat prompt length, chunk length, chunk start) of the unit's
    scoring forwards."""
    ctx = np.zeros(u["ctx"], np.int64)
    return [(len(r), n, s) for s, n, r in repeat_prompts(rec["model"]["family"], ctx)]


def ingest_unit(rec: dict, u: dict) -> dict:
    """A document: the bound of its context attention (prefill and the
    scoring forwards), of its scores, and its model operations over the
    peaks (seconds)."""
    H, Hkv, D, L = dims(rec)
    pk, int4 = rec["peaks"], _int4(rec)
    bf, bw = pk["bf16_flops"], pk["hbm_bytes_per_s"]
    N = linear.params(rec["model"])
    P, sink = u["P"], u["sink"]
    ops, nb = attention.causal(H, Hkv, D, P, 0, int4)
    ctx_b = L * bound_s(ops, nb, bf, bw)
    t_model = 2 * N * P / _lin_peak(rec, DEQUANT_ROWS) + L * ops / bf
    score_b = 0.0
    for n_q, n, _ in chunks(rec, u):
        ops, nb = attention.causal(H, Hkv, D, n_q, P, int4)
        ctx_b += L * bound_s(ops, nb, bf, bw)
        s_ops, s_nb = attention.scores(H, Hkv, D, n_q, sink, n)
        score_b += L * bound_s(s_ops, s_nb, bf, bw)
        t_model += 2 * N * n_q / _lin_peak(rec, DEQUANT_ROWS) + L * (ops + s_ops) / bf
    live = sum(u["layer_rows"]) / L if u.get("layer_rows") else 0
    for q, a in zip(u["queries"], u["answers"]):
        ops, _ = attention.pool_decode(H, Hkv, D, q, live, [0], int4)
        t_model += 2 * N * q / _lin_peak(rec, q) + L * ops / bf
        for i in range(max(len(a) - 1, 0)):
            ops, _ = attention.pool_decode(H, Hkv, D, 1, live, [q + i], int4)
            t_model += 2 * N / _lin_peak(rec, 1) + L * ops / bf
    return {"ctx_attn": ctx_b, "score": score_b, "model": t_model}


def serve_unit(rec: dict, u: dict) -> dict:
    """A batch: the bound of its decode steps' attention over the merged
    pool and of their linears, and its model operations over the peaks
    (seconds)."""
    H, Hkv, D, L = dims(rec)
    pk, int4 = rec["peaks"], _int4(rec)
    bf, bw = pk["bf16_flops"], pk["hbm_bytes_per_s"]
    N = linear.params(rec["model"])
    B, q_lens, steps = u["B"], u["q_lens"], u["steps"]
    rows = u["layer_rows"]
    live = sum(rows) / L
    t_model = 2 * N * sum(q_lens) / _lin_peak(rec, B * max(q_lens))
    for ql in q_lens:
        ops, _ = attention.pool_decode(H, Hkv, D, ql, live / B, [0], int4)
        t_model += L * ops / bf
    attn_b = 0.0
    lin_b = steps * linear.step_bound(rec["model"], rec["quant"], B, pk)
    for i in range(steps):
        tails = [q + i for q in q_lens]
        for r in rows:
            ops, nb = attention.pool_decode(H, Hkv, D, 1, r, tails, int4)
            attn_b += bound_s(ops, nb, bf, bw)
            t_model += ops / bf
        t_model += 2 * N * B / _lin_peak(rec, B)
    return {"decode_attn": attn_b, "decode_linear": lin_b, "model": t_model}
