"""On the card: the tracer's spans and device operations share one clock,
so a synced span holds the work it launched, and the reductions read it.
Marked ``cuda``; skips elsewhere."""

import pytest
import torch

from portbench import tracing


@pytest.mark.cuda
def test_spans_hold_their_device_work(card):
    tr = tracing.Tracer(True, card)
    a = torch.randn(4096, 4096, device=card, dtype=torch.bfloat16)
    tr.begin()
    with tr.span("u0:unit"):
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
    torch.cuda._sleep(10 ** 6)  # outside any span
    with tr.span("u1:unit"):
        a = a @ a
    tr.end()
    rec = {"units": [{"spans": {"unit": "u0:unit"}}, {"spans": {"unit": "u1:unit"}}],
           "spans": tr.spans, "ops": tr.ops}
    wins = tracing.windows(rec, "unit")
    assert len(wins) == 2 and all(t1 > t0 for t0, t1 in wins)
    assert not any(name.startswith(tracing.PREFIX) for name, _, _ in tr.ops)
    busy, span = tracing.busy(rec, wins), tracing.length(wins)
    assert 0 < busy <= span
    assert tracing.op_time(rec, wins[:1], "gemm|nvjet|cutlass|xmma") > 0
    assert tracing.op_time(rec, wins, "sleep") == 0
