"""Attention, quantized-linear and activation-quantization ops of the port:
each kernel wrapper beside its plain version.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches its hand-written kernel (``csrc/``) or raises. Every
kernel launch adds one to ``LAUNCHES[<wrapper name>]`` (``<wrapper
name>_q8`` for the int8-attention mode of K7 and K11), so a run can show
which kernels its path went through. K5's decode form (T <= 16) also adds
one to ``LAUNCHES["flash_attend_int4_decode"]``, so its two forms can be
told apart. A replayed CUDA graph runs no Python: the engine's captured
decode step adds its capture's counts once for each replay that advanced
its answer, to ``LAUNCHES`` and to every other dict of int counts in
``COUNTS`` (a caller's own tally of some wrapper's calls, registered
there), so each count stays what the eager calls would have made. Decode
counts are therefore per advanced step, not raw launches: a replay that
advances nothing (the capture's warm-up, the rest of a chunk after the
answer ends, replays made only to time the step) launches every captured
kernel and counts none. ``COLLECTIVES`` counts the sharded forward's
collectives the same way (``parallel/collectives.py``: "all_reduce model",
"all_gather model", ...).
"""

from __future__ import annotations

import functools

import torch

LAUNCHES = {"flash_attend": 0, "fused_scores": 0, "ragged_decode_attend": 0,
            "pool_decode_attend": 0, "flash_attend_int4": 0,
            "flash_attend_int4_decode": 0, "flash_attend_int4_extra": 0,
            "pool_decode_attend_int4": 0, "w4a8_matmul_stacked_v2": 0,
            "windowed_attend": 0, "rmsnorm_quant": 0, "silu_mul_quant": 0,
            "pool_decode_attend_int4_q8": 0, "flat_decode_attend": 0,
            "flat_decode_attend_int4": 0, "flat_decode_attend_int4_q8": 0,
            "w4a8_layer_fused": 0, "w4a8_matmul_stacked": 0, "w4a8_matmul": 0}


COLLECTIVES = {}  # the sharded forward's collectives by name and mesh axis

COUNTS = [LAUNCHES, COLLECTIVES]  # every dict of int counts a replay adds to


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts_snapshot() -> list:
    """Copies of every dict in ``COUNTS``."""
    return [dict(c) for c in COUNTS]


def counts_restore(snap: list) -> None:
    """Set every dict in ``COUNTS`` back to a snapshot."""
    for c, old in zip(COUNTS, snap):
        c.clear()
        c.update(old)


def counts_since(snap: list) -> list:
    """What each dict in ``COUNTS`` gained since a snapshot."""
    return [{k: v - old.get(k, 0) for k, v in c.items() if v != old.get(k, 0)}
            for c, old in zip(COUNTS, snap)]


def counts_add(delta: list, times: int) -> None:
    """Add ``times`` x a ``counts_since`` delta to the dicts in ``COUNTS``."""
    for c, d in zip(COUNTS, delta):
        for k, v in d.items():
            c[k] = c.get(k, 0) + v * times


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the call goes to the kernel, False for the plain version.
    Mixed devices raise."""
    devs = {t.device.type for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    return devs == {"cuda"}


HEAD_DIM = 128  # the head_dim the kernels are built for (csrc/attn_common.cuh)


def check_kernel_args(what: str, bf16: dict, int32: dict = None,
                      other: dict = None) -> None:
    """Validate a kernel call, all tensors contiguous: ``bf16`` holds bf16
    rows of the head_dim the kernels are built for, ``int32`` int32
    tensors, and ``other`` maps a name to (tensor, dtype) for any other
    operand (packed uint8 rows, scales)."""
    for name, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} must be bfloat16, got {t.dtype}")
        if t.shape[-1] != HEAD_DIM:
            raise ValueError(f"{what}: {name} head_dim {t.shape[-1]} != {HEAD_DIM}")
    checks = {**{n: (t, torch.int32) for n, t in (int32 or {}).items()},
              **(other or {})}
    for name, (t, dtype) in checks.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    for name, t in {**bf16, **{n: t for n, (t, _) in checks.items()}}.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_tma_aligned(what: str, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor starts on a 16-byte boundary: the
    Hopper kernels (K1, K5's prefill form, K6, K9) load them through TMA."""
    bad = [n for n, t in tensors.items() if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{what}: {', '.join(bad)} must start on 16-byte "
                         f"boundaries (TMA)")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_tickets = {}  # (kernel, device) -> its arrival counts, zero between launches


def ticket_buffer(owner: str, device: torch.device, n: int) -> torch.Tensor:
    """At least n zeroed int32 arrival counts of the kernel ``owner`` on
    ``device`` (the first call at a size must not be inside a CUDA-graph
    capture); each of its launches leaves its counts zero. A larger request
    replaces the buffer here; a CUDA graph captured with the old one keeps
    it alive by holding it (``ticket_buffers``)."""
    t = _tickets.get((owner, device))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(owner, device)] = t
    return t


def ticket_buffers() -> list:
    """Every ticket buffer in use now: what a CUDA graph captured now may
    replay (the engine's decode step holds them as long as its graph)."""
    return list(_tickets.values())


# Holding a kernel's output against its plain version computed in float32
# from the same bf16 inputs (chip_smoke.py, tests/test_torch_kernels.py).
# An attention kernel rounds twice, p to bf16 for the p.v product and the
# output to bf16, each by at most 2^-8 of the value. K2 rounds each logit to
# bf16 before the softmax, and one bf16 ulp of a logit in [4, 8) moves its
# probability by 3.2%.
OUT_RTOL = 2.0 ** -7
SCORE_RTOL = 2.0 ** -4
ATOL_SHARE = 0.02       # of RMS(want): accumulation order, bf16 p's error tail
RMS_SHARE = 2.0 ** -7   # RMS(got - want) <= RMS_SHARE * RMS(want)


def parity(got: torch.Tensor, want: torch.Tensor, rtol: float,
           slack: torch.Tensor = None) -> dict:
    """Elementwise ``|got - want| <= rtol |want| + ATOL_SHARE RMS(want)``
    (``worst_to_tol`` is the largest ratio of the two sides) and an error
    RMS at most ``RMS_SHARE`` of the reference's, which catches an error
    spread thin over every element (a wrong normaliser, a dropped split).
    ``slack`` (broadcast to got's shape) is a difference the comparison
    discounts from each element first: in the int8-attention mode, the
    quantized-p steps that may flip (``attention.attend_int4_q8``)."""
    w = want.float()
    err = (got.float() - w).abs()
    if slack is not None:
        err = (err - slack.float()).clamp_min(0)
    rms = w.square().mean().sqrt().item()
    worst = (err / (rtol * w.abs() + ATOL_SHARE * rms + 1e-30)).max().item()
    rel_rms = err.square().mean().sqrt().item() / max(rms, 1e-30)
    return dict(max_abs_err=err.max().item(), rms_want=rms, worst_to_tol=worst,
                rel_rms_err=rel_rms, ok=worst <= 1.0 and rel_rms <= RMS_SHARE)


# Holding an int8 quantization kernel (K13, K14) against its plain version:
# the kernel's sum of squares, rsqrtf and expf/tanhf differ from PyTorch's
# in the last bits of h, which moves a value lying within those bits of a
# rounding boundary to the next int8 step; nothing else may differ.
Q_STEP_SHARE = 1e-3  # share of int8 elements that may be one step away
SCALE_RTOL = 1e-5    # per-token scales, relative


def quant_parity(got_q: torch.Tensor, got_s: torch.Tensor,
                 want_q: torch.Tensor, want_s: torch.Tensor) -> dict:
    """int8 rows equal except for one step on at most ``Q_STEP_SHARE`` of
    the elements, scales within ``SCALE_RTOL`` relative. ``worst_to_tol``
    is the larger of the two shares over their limits; ``max_abs_err`` and
    ``rms_want`` are of the dequantized rows ``q * s``."""
    dq = (got_q.int() - want_q.int()).abs()
    gs, ws = got_s.float(), want_s.float()
    s_rel = ((gs - ws).abs() / ws.abs().clamp_min(1e-30)).max().item()
    max_step = dq.max().item()
    share = (dq != 0).float().mean().item()
    want = want_q.float() * ws
    return dict(max_step=max_step, step_share=share, scale_rel_err=s_rel,
                max_abs_err=(got_q.float() * gs - want).abs().max().item(),
                rms_want=want.square().mean().sqrt().item(),
                worst_to_tol=max(share / Q_STEP_SHARE, s_rel / SCALE_RTOL),
                ok=max_step <= 1 and share <= Q_STEP_SHARE and s_rel <= SCALE_RTOL)
