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

K13's plan (``plan_norm``, ``norm_geometry``, ``norm_vectors``): every
row lies with exactly one CTA of the grid and every vector of a row with
exactly one (thread, slot), a kernel thread standing for K of the first
form's threads, at D 4,096, 8, 5,120 and 32,768 and T 1, 3, 16 and 2,304;
and a float32 emulation of the kernel's sum of squares (each first-form
thread's vectors in order, then the warp's and the block's butterfly
trees) in the kernel's split gives the bits of the same emulation in the
first kernel's split (its geometry as that kernel computed it), and holds
against ``rmsnorm_quant_plain`` within ``ops.quant_parity``. A sum depends
on its order, so the split is what keeps K13's output its first form's.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kvzip_tpu_torch.ops import fused_act, quant_parity
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


NORM_WIDTHS = [4096, 8, 5120, 32768]


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("D", NORM_WIDTHS)
@pytest.mark.parametrize("T", [1, 3, 16, 2304])
def test_plan_norm_covers_each_row_and_vector_once(T, D, sms):
    grid, nthr, K, stages = fused_act.plan_norm(T, D, sms)
    vpt, want = fused_act.norm_geometry(D)
    assert nthr == want and nthr % 32 == 0 and 32 <= nthr <= fused_act.MAX_THREADS
    assert K in (1, 2, 4) and (K == 1 or vpt == 1) and nthr % (32 * K) == 0
    assert 1 <= stages <= fused_act.NORM_STAGES and stages * 2 * D <= 128 * 1024
    assert 1 <= grid <= max(T, 1)
    rows = sorted(r for b in range(grid) for r in range(b, T, grid))
    assert rows == list(range(T))
    per_sm = min(32, (2 if vpt == 1 and K == 1 else 1) * 1024 // (nthr // K))
    assert grid <= sms * per_sm and (grid == T or T > sms * per_sm)  # one row a CTA if it can
    assert per_sm * stages * 2 * D <= fused_act.NORM_SMEM
    threads = fused_act.norm_vectors(D, nthr, K)
    assert len(threads) == nthr // K and all(len(t) == K for t in threads)
    assert sorted(v for t in threads for vecs in t for v in vecs) == list(range(D // 8))
    assert max(len(vecs) for t in threads for vecs in t) <= vpt <= fused_act.MAX_VPT


def _first_form_split(D):
    """The first K13 kernel's split, as its ``geometry`` computed it: VPT
    doubled until 1,024 threads cover the row, threads rounded to warps,
    thread t taking vectors t + j * threads for j < VPT."""
    nvec = D // 8
    vpt = 1
    while vpt * 1024 < nvec:
        vpt *= 2
    nthr = ((nvec + vpt - 1) // vpt + 31) // 32 * 32
    return [[t + j * nthr for j in range(vpt) if t + j * nthr < nvec] for t in range(nthr)]


def _kernel_split(D, nthr, K):
    """``norm_vectors``' split put back in the first form's thread order:
    the kernel's thread t, slot k stands for that form's thread (t // 32 +
    k * warps) * 32 + t % 32, whose warp butterfly and block slot it
    repeats."""
    split = [None] * nthr
    warps = nthr // K // 32
    for t, slots in enumerate(fused_act.norm_vectors(D, nthr, K)):
        for k, vecs in enumerate(slots):
            split[(t // 32 + k * warps) * 32 + t % 32] = vecs
    return split


def _butterfly(v):
    """A warp's __shfl_xor_sync sum over its last axis of 32 lanes, in
    float32 (every lane ends with the same value)."""
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., np.arange(32) ^ o]).astype(np.float32)
    return v[..., 0]


def _emulate_norm(x, w, eps, split):
    """K13's arithmetic in float32 for a split [thread] -> vectors: each
    thread adds its elements' squares in order, then the block's two-level
    butterfly; h = x * r * w; scale and int8 as the kernel's."""
    T, D = x.shape
    nthr = len(split)
    sq = (x * x).astype(np.float32)
    ss = np.zeros((T, nthr), np.float32)
    for t, vecs in enumerate(split):
        for v in vecs:
            for e in range(8):
                ss[:, t] = (ss[:, t] + sq[:, v * 8 + e]).astype(np.float32)
    nw = nthr // 32
    warp = _butterfly(ss.reshape(T, nw, 32))
    lanes = np.zeros((T, 32), np.float32)
    lanes[:, :nw] = warp
    total = _butterfly(lanes)
    r = (1.0 / np.sqrt((total / np.float32(D) + np.float32(eps)).astype(np.float32))
         ).astype(np.float32)
    h = ((x * r[:, None]).astype(np.float32) * w[None]).astype(np.float32)
    s = (np.abs(h).max(-1) / np.float32(127) + np.float32(1e-8)).astype(np.float32)
    q = np.clip(np.rint(h / s[:, None]), -127, 127).astype(np.int8)
    return q, s[:, None]


@pytest.mark.parametrize("D", NORM_WIDTHS)
@pytest.mark.parametrize("T", [1, 3, 16])
def test_norm_sum_order_is_the_first_forms(T, D):
    rng = np.random.default_rng(T * 11 + D)
    x = torch.from_numpy((rng.standard_normal((T, D)) * 3).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((1 + 0.2 * rng.standard_normal(D)).astype(np.float32)).to(torch.bfloat16)
    xf, wf = x.float().numpy(), w.float().numpy()
    _, nthr, K, _ = fused_act.plan_norm(T, D, SMS)
    q, s = _emulate_norm(xf, wf, 1e-5, _kernel_split(D, nthr, K))
    q0, s0 = _emulate_norm(xf, wf, 1e-5, _first_form_split(D))
    assert np.array_equal(q, q0) and np.array_equal(s.view(np.int32), s0.view(np.int32))
    r = quant_parity(torch.from_numpy(q), torch.from_numpy(s),
                     *fused_act.rmsnorm_quant_plain(x, w, 1e-5))
    assert r["ok"], r
