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
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from kvzip_tpu_torch import _build
from kvzip_tpu_torch.ops import LAUNCHES, check_kernel_args, on_cuda, stream_ptr

EPS = 1e-8
ACTS = ("silu", "gelu_pytorch_tanh")
MAX_WIDTH = 32768  # the widest row the kernels hold in registers

_ARGS_NORM = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_ARGS_ACT = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    with torch.cuda.device(x.device):
        fn = _build.kernel("fused_act", "kvz_rmsnorm_quant", _ARGS_NORM)
        _build.check(fn(x.data_ptr(), w.data_ptr(), q.data_ptr(), s.data_ptr(),
                        T, D, eps, int(gemma), stream_ptr(x.device)),
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
    T, Fw = gate.shape
    q = torch.empty((T, Fw), dtype=torch.int8, device=gate.device)
    s = torch.empty((T, 1), dtype=torch.float32, device=gate.device)
    with torch.cuda.device(gate.device):
        fn = _build.kernel("fused_act", "kvz_silu_mul_quant", _ARGS_ACT)
        _build.check(fn(gate.data_ptr(), up.data_ptr(), q.data_ptr(), s.data_ptr(),
                        T, Fw, ACTS.index(act), stream_ptr(gate.device)),
                     "silu_mul_quant")
    LAUNCHES["silu_mul_quant"] += 1
    return q, s
