"""K14's launch plan (``kvzip_tpu_torch/ops/fused_act.py::plan`` and
``cta_vectors``), which mirrors ``csrc/fused_act.cu``: every 16-byte vector
of a row lies with exactly one thread of one CTA, the cluster sizes are
ones the CUDA entry takes (4, 8 or 16 CTAs, a thread at most four
vectors), the form switch follows the plan's CTA budgets, and the kernel's
way of taking a row's maximum (each warp's slice, then the maximum over
the cluster's warps) quantizes bit for bit as ``silu_mul_quant_plain``
does, at F 14,336, 11,008, 8 and 32,768 and T 1, 3, 16 and a chunk above
the switch to the row form. The maximum is exact in any order, so the
hold is exact.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kvzip_tpu_torch.ops import fused_act
from test_torch_engine import one_torch_thread  # noqa: F401

SMS = 132  # the H100 SXM's SM count
WIDTHS = [14336, 11008, 8, 32768]


def _entry_accepts(Fw: int, C: int, nthr: int) -> bool:
    """The checks of ``kvz_silu_mul_quant`` before it launches."""
    if Fw % 8 or Fw <= 0 or Fw > fused_act.MAX_WIDTH:
        return False
    if C == 0:
        return nthr == fused_act.RF_THREADS
    per = -(-(Fw // 8) // C)
    return (C in (4, 8, fused_act.CL_MAX) and nthr % 32 == 0 and 32 <= nthr
            <= fused_act.CL_THREADS and per <= nthr * fused_act.CL_VPT)


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("Fw", WIDTHS)
def test_plan_covers_each_vector_once(Fw, sms):
    for T in (1, 2, 3, 8, 9, 16, 17, 24, 33, 56, 57, 66, 67, 100, 2304, 4097):
        C, nthr = fused_act.plan(T, Fw, sms)
        assert _entry_accepts(Fw, C, nthr), (T, C, nthr)
        assert C == 0 or T * C <= (sms // 2 if C == 16 else 3 * sms)
        ctas = fused_act.cta_vectors(Fw, C, nthr)
        assert len(ctas) == max(C, 1) and all(len(c) == nthr for c in ctas)
        vecs = sorted(v for cta in ctas for thread in cta for v in thread)
        assert vecs == list(range(Fw // 8))
        if C:
            assert max(len(thread) for cta in ctas for thread in cta) <= fused_act.CL_VPT


@pytest.mark.parametrize("Fw", WIDTHS)
def test_form_switch(Fw):
    """Clusters of 16 while 16 T CTAs fill at most half the SMs, of 8 or 4
    while C T CTAs stay within three an SM, each CTA with 32 to 1,024
    vectors; the row form otherwise (from T 100 on at 132 SMs)."""
    nvec = Fw // 8
    forms = {T: fused_act.plan(T, Fw, SMS)[0] for T in range(1, 200)}
    for T, C in forms.items():
        fits = [c for c, ctas in ((16, SMS // 2), (8, 3 * SMS), (4, 3 * SMS))
                if T * c <= ctas and 32 <= -(-nvec // c) <= 1024]
        assert C == (fits[0] if fits else 0), (T, C)
    assert all(C == 0 for T, C in forms.items() if T >= 100)
    if Fw == 14336:
        assert [forms[T] for T in (1, 4, 5, 49, 50, 99, 100)] == [16, 16, 8, 8, 4, 4, 0]


def _act(g, u, act):
    if act == "silu":
        return g * torch.sigmoid(g) * u
    return F.gelu(g, approximate="tanh") * u


def _emulate(gate, up, act):
    """The kernel's row maxima: each thread's vectors (``cta_vectors``),
    a warp's maximum over its 32 threads' elements, then the maximum over
    every warp of the row's CTAs; then the plain quantization."""
    T, Fw = gate.shape
    C, nthr = fused_act.plan(T, Fw, SMS)
    h = _act(gate.float(), up.float(), act)
    warp_max = []
    for cta in fused_act.cta_vectors(Fw, C, nthr):
        for w in range(0, nthr, 32):
            vecs = [v for thread in cta[w:w + 32] for v in thread]
            if not vecs:
                continue
            cols = (torch.tensor(vecs)[:, None] * 8 + torch.arange(8)).reshape(-1)
            warp_max.append(h[:, cols].abs().amax(-1))
    amax = torch.stack(warp_max).amax(0)[:, None]
    s = amax / 127.0 + fused_act.EPS
    return torch.clamp(torch.round(h / s), -127, 127).to(torch.int8), s


@pytest.mark.parametrize("act", fused_act.ACTS)
@pytest.mark.parametrize("Fw", WIDTHS)
@pytest.mark.parametrize("T", [1, 3, 16, 100])
def test_emulated_slices_quantize_as_plain(T, Fw, act):
    rng = np.random.default_rng(T * 7 + Fw)
    gate = torch.from_numpy((rng.standard_normal((T, Fw)) * 3).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((T, Fw)).astype(np.float32))
    gate, up = gate.to(torch.bfloat16), up.to(torch.bfloat16)
    q, s = _emulate(gate, up, act)
    want_q, want_s = fused_act.silu_mul_quant_plain(gate, up, act)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
