"""K13 and K14: fused activation quantization of the W8A8 path.

Port of ``kvzip_tpu/ops/fused_act.py`` (QServe's ``RMSNormGeneral`` and
``SiluAndMulQuant``); the kernels are ``csrc/fused_act.cu``.

- K13 ``rmsnorm_quant``: RMSNorm of x (T, D) with weight w (D,) (``1 + w``
  under ``gemma``), then dynamic per-token symmetric int8 quantization.
- K14 ``silu_mul_quant``: ``act(gate) * up`` of (T, F) rows for ``act`` in
  {"silu", "gelu_pytorch_tanh"}, then the same quantization.

Both compute in float32 throughout, with no rounding to the model dtype
between the norm (or activation) and the quantization:
``s = amax(|h|) / 127 + 1e-8`` and ``q = clamp(round(h / s), -127, 127)``,
round half to even. Both return (int8 (T, W), float32 scales (T, 1)).

K13's kernel takes its rows every grid-th over a grid sized to the card,
each CTA keeping a few rows in flight (:func:`plan_norm`), each row split
over a CTA's threads as :func:`norm_vectors` gives. K14's kernel has two forms, which :func:`plan`
picks and the CUDA entry takes as given: at small T a row is split over a cluster of C CTAs (each
warp's maximum pushed into every CTA's shared memory), at large T one CTA
a row stages gate and up in shared memory. :func:`cta_vectors` gives
the 16-byte vectors each thread of either form takes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import (LAUNCHES, check_kernel_args, check_tma_aligned, on_cuda,
                                 sm_count, stream_ptr)

EPS = 1e-8
ACTS = ("silu", "gelu_pytorch_tanh")
MAX_WIDTH = 32768  # the widest row the kernels take (K13 in registers)

VEC = 8            # elements a 16-byte vector (csrc/fused_act.cu VEC)
CL_MAX = 16        # K14: CTAs a cluster, at most (above 8 non-portable)
CL_MIN_VECS = 32   # K14: vectors a CTA of the cluster form, at least
CL_THREADS = 256   # K14: threads a CTA of the cluster form, at most
CL_VPT = 4         # K14: vectors a thread of the cluster form, at most
RF_THREADS = 512   # K14: threads a CTA of the row form

MAX_THREADS = 1024  # K13: threads of the first form's CTA, at most
MAX_VPT = 4        # K13: vectors a thread, at most
NORM_SPLIT = 2     # K13: the first form's threads a thread stands for (one vector each)
NORM_STAGES = 2    # K13: rows a CTA keeps in flight, at most (the entry takes 4)
NORM_SMEM = 196608  # K13: bytes of rows in flight an SM, at most
_ARGS_NORM = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def norm_geometry(D: int) -> Tuple[int, int]:
    """K13's split of a row of D elements (``csrc/fused_act.cu::geometry``):
    (vectors a thread, threads a CTA), the fewest vectors a thread (a power
    of two) that 1,024 threads cover the row's D / 8 vectors with."""
    nvec = D // VEC
    vpt = 1
    while vpt * MAX_THREADS < nvec:
        vpt *= 2
    vecs = -(-nvec // vpt)  # a thread's share of the row's vectors, VPT at most
    return vpt, -(-vecs // 32) * 32


def plan_norm(T: int, D: int, sms: int, split: int = NORM_SPLIT) -> Tuple[int, int, int, int]:
    """K13's launch for T rows of width D on ``sms`` SMs: (grid, the first
    form's threads ``norm_geometry`` gives, K, rows a CTA keeps in flight).
    At one vector a thread, a thread of the kernel stands for K (``split``
    at most, 1, 2 or 4, whole warps) of the first form's threads, so a CTA
    has threads / K. A CTA takes rows b, b + grid, ...; the grid holds what
    the card surely keeps resident (K = 1 at one vector a thread: a kernel
    built for 32 registers, 2,048 threads an SM; otherwise 64 registers,
    1,024 threads; 32 CTAs an SM at most) and splits the rows evenly over
    as few rounds as that allows: one row a CTA up to that size. A CTA's
    ring holds up to ``NORM_STAGES`` rows (two ran T 4,096 in 0.0208 ms on
    the H100 where four took 0.0230), ``NORM_SMEM`` bytes an SM and 128 KB
    a CTA at most."""
    vpt, nthr = norm_geometry(D)
    K = next((k for k in (4, 2) if k <= split and vpt == 1 and nthr % (32 * k) == 0), 1)
    per_sm = min(32, (2 if vpt == 1 and K == 1 else 1) * MAX_THREADS // (nthr // K))
    rounds = -(-T // (sms * per_sm))
    stages = max(1, min(NORM_STAGES, NORM_SMEM // (per_sm * 2 * D), 131072 // (2 * D)))
    return max(1, -(-T // max(rounds, 1))), nthr, K, stages


def norm_vectors(D: int, nthr: int, K: int = 1) -> list:
    """The 16-byte vectors of a row each of K13's threads takes, in the
    order it adds their squares, for the first form's ``nthr`` threads, a
    thread of the kernel standing for K of them: [thread][k] -> the vector
    indices p, p + nthr, ... below D / 8 (at most ``MAX_VPT``) of the first
    form's thread p = (warp + k * warps) * 32 + lane, warps = nthr / K / 32;
    each k's vectors are summed on their own, as that thread's."""
    nvec = D // VEC
    n = nthr // K
    return [[list(range((t // 32 + k * (n // 32)) * 32 + t % 32, nvec, nthr)) for k in range(K)]
            for t in range(n)]


_ARGS_ACT = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def plan(T: int, F: int, sms: int) -> Tuple[int, int]:
    """K14's form for T rows of width F on ``sms`` SMs: (C, threads a CTA).
    C > 0 is the cluster form, each row split over C CTAs: 16 while the
    16 T CTAs fill at most half the SMs, else 8 or 4 while C T CTAs stay
    within three an SM (measured on the H100 at F 14,336: clusters of 16
    and 8 tie at T 1-4, 8 wins from T 8 to 48, 4 at T 64 and 96; the row
    form ties 4 at T 100 and loses to it by 7% at 128), each CTA with at
    least ``CL_MIN_VECS`` vectors and its threads at most ``CL_VPT`` each.
    Otherwise (C = 0) the row form: one CTA of ``RF_THREADS`` a row."""
    nvec = F // VEC
    for C, ctas in ((CL_MAX, sms // 2), (8, 3 * sms), (4, 3 * sms)):
        per = -(-nvec // C)
        if T * C <= ctas and CL_MIN_VECS <= per <= CL_THREADS * CL_VPT:
            return C, min(CL_THREADS, -(-per // 32) * 32)
    return 0, RF_THREADS


def cta_vectors(F: int, C: int, nthr: int) -> list:
    """The 16-byte vectors of a row each thread takes, as the kernel's forms
    index them: [CTA][thread] -> vector indices. Cluster form (C > 0): CTA c
    takes [c * per, min(nvec, (c + 1) * per)), per = ceil(nvec / C), its
    thread t the slice's vectors t, t + nthr, ...; row form (C = 0): one
    CTA, thread t the vectors t, t + nthr, ..."""
    nvec = F // VEC
    if C == 0:
        return [[list(range(t, nvec, nthr)) for t in range(nthr)]]
    per = -(-nvec // C)
    return [[list(range(min(nvec, c * per + t), min(nvec, (c + 1) * per), nthr))
             for t in range(nthr)] for c in range(C)]


def _quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = h.abs().amax(dim=-1, keepdim=True) / 127.0 + EPS
    q = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
    return q, s


def rmsnorm_quant_plain(x, w, eps, gemma=False):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    h = xf * torch.rsqrt(var + eps)
    wv = w.float()
    return _quantize_rows(h * ((1.0 + wv) if gemma else wv))


def silu_mul_quant_plain(gate, up, act="silu"):
    g, u = gate.float(), up.float()
    if act == "silu":
        h = g * torch.sigmoid(g) * u
    elif act == "gelu_pytorch_tanh":
        h = F.gelu(g, approximate="tanh") * u
    else:
        raise ValueError(f"act: {act!r}")
    return _quantize_rows(h)


def _check_rows(what: str, **rows) -> None:
    check_kernel_args(what, {}, None,
                      {n: (t, torch.bfloat16) for n, t in rows.items()})
    shapes = {tuple(t.shape) for t in rows.values() if t.dim() == 2}
    if len(shapes) != 1 or next(iter(shapes))[1] % 8 \
            or next(iter(shapes))[1] > MAX_WIDTH:
        raise ValueError(f"{what}: rows must be (T, W) with W a multiple of 8 "
                         f"and at most {MAX_WIDTH}, got "
                         f"{[tuple(t.shape) for t in rows.values()]}")


def rmsnorm_quant(x: torch.Tensor, w: torch.Tensor, eps: float,
                  gemma: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D), w (D,) -> (int8 (T, D), float32 (T, 1)); ``q * s`` is
    ``rms_norm(x, w)`` quantized per token."""
    if not on_cuda(x, w):
        return rmsnorm_quant_plain(x, w, eps, gemma)
    _check_rows("rmsnorm_quant", x=x, w=w)
    T, D = x.shape
    if w.shape != (D,):
        raise ValueError(f"rmsnorm_quant: w {tuple(w.shape)} != ({D},)")
    q = torch.empty((T, D), dtype=torch.int8, device=x.device)
    s = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    check_tma_aligned("rmsnorm_quant", x=x, w=w)
    grid, nthr, K, stages = plan_norm(T, D, sm_count(x.device))
    with torch.cuda.device(x.device):
        fn = _build.kernel("fused_act", "kvz_rmsnorm_quant", _ARGS_NORM)
        _build.check(fn(x.data_ptr(), w.data_ptr(), q.data_ptr(), s.data_ptr(),
                        T, D, eps, int(gemma), grid, nthr, K, stages, stream_ptr(x.device)),
                     "rmsnorm_quant")
    LAUNCHES["rmsnorm_quant"] += 1
    return q, s


def silu_mul_quant(gate: torch.Tensor, up: torch.Tensor, act: str = "silu"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gate/up (T, F) -> (int8 (T, F), float32 (T, 1)) of act(gate) * up."""
    if act not in ACTS:
        raise ValueError(f"act: {act!r}")
    if not on_cuda(gate, up):
        return silu_mul_quant_plain(gate, up, act)
    _check_rows("silu_mul_quant", gate=gate, up=up)
    check_tma_aligned("silu_mul_quant", gate=gate, up=up)
    T, Fw = gate.shape
    return _launch_act(gate, up, act, *plan(T, Fw, sm_count(gate.device)))


def _launch_act(gate, up, act, C, nthr):
    """One K14 launch in the given form (``plan``'s (C, threads))."""
    T, Fw = gate.shape
    q = torch.empty((T, Fw), dtype=torch.int8, device=gate.device)
    s = torch.empty((T, 1), dtype=torch.float32, device=gate.device)
    with torch.cuda.device(gate.device):
        fn = _build.kernel("fused_act", "kvz_silu_mul_quant", _ARGS_ACT)
        _build.check(fn(gate.data_ptr(), up.data_ptr(), q.data_ptr(), s.data_ptr(),
                        T, Fw, ACTS.index(act), C, nthr, stream_ptr(gate.device)),
                     "silu_mul_quant")
    LAUNCHES["silu_mul_quant"] += 1
    return q, s
