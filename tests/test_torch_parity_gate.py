"""The gate that holds a CUDA kernel against its plain version
(``kvzip_tpu_torch.ops.parity``), on the CPU: it accepts the rounding a
bf16 attention kernel does (probabilities to bf16 for the p.v product, the
output to bf16) and rejects a result with one 64-key split left out, or,
for K2's scores, the last 16 queries left out.
"""

import pytest
import torch

from kvzip_tpu_torch.ops import OUT_RTOL, SCORE_RTOL, parity, score_kernel

D = 128


def _attend(q, k, v, n_keys, *, bf16_rounding):
    """One kv head: q (R, D) over the first n_keys rows of k/v (S, D).
    With ``bf16_rounding``, rounds p and the output to bf16 as a kernel
    does; the row sum stays float32."""
    s = q @ k[:n_keys].T * D ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = p.bfloat16().float() if bf16_rounding else p
    out = pv @ v[:n_keys] / p.sum(-1, keepdim=True)
    return out.bfloat16().float() if bf16_rounding else out


@pytest.mark.parametrize("rows,n_keys", [(7, 4096), (56, 4096), (2, 16384)])
def test_gate_accepts_rounding_rejects_dropped_split(rows, n_keys):
    gen = torch.Generator().manual_seed(rows + n_keys)
    q = torch.randn(rows, D, generator=gen).bfloat16().float()
    k = torch.randn(n_keys, D, generator=gen).bfloat16().float()
    v = torch.randn(n_keys, D, generator=gen).bfloat16().float()
    want = _attend(q, k, v, n_keys, bf16_rounding=False)
    got = _attend(q, k, v, n_keys, bf16_rounding=True)
    assert parity(got, want, OUT_RTOL)["ok"]
    dropped = _attend(q, k, v, n_keys - 64, bf16_rounding=True)
    r = parity(dropped, want, OUT_RTOL)
    assert not r["ok"] and r["rel_rms_err"] > 4 * 2.0 ** -7


@pytest.mark.parametrize("H,Hkv", [(4, 2), (14, 2)])
def test_gate_on_scores_rejects_dropped_queries(H, Hkv):
    gen = torch.Generator().manual_seed(H)
    sink, s_ctx, T, ctx_len = 16, 512, 576, 500
    q = torch.randn(T, H, D, generator=gen).bfloat16()
    keys = torch.randn(Hkv, sink + s_ctx + T, D, generator=gen).bfloat16()
    kw = dict(sink=sink, s_ctx=s_ctx, scale=D ** -0.5, model_dtype=torch.bfloat16)
    want = score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len, 540, **kw)
    assert parity(want * (1 + 2.0 ** -10), want, SCORE_RTOL)["ok"]
    dropped = score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len, 524, **kw)
    assert not parity(dropped, want, SCORE_RTOL)["ok"]
