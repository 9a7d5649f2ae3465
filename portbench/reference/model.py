"""Plain float32 PyTorch forward of the qwen2 and qwen3 decoders, with the
quantized formats a configuration may state, written out again.

Nothing here imports the program. The weights are the benchmark's own
bf16 tree (``portbench/weights.py``), the layout the program is handed:
stacked ``(L, in, out)`` projections applied as ``x @ w``, ``(V, D)``
embedding and head. Each layer's weights are taken to float32 when the
layer runs. TF32 is off.

Quantized formats (``quant`` in the configuration file), as stated there:

- ``weights: "w4a8"``: int4 weights per group of 128 input rows and output
  column, asymmetric, ``s = (max - min) / 15 + 1e-8`` and ``z = min``
  stored in bf16 (the nibble chosen with the stored values); activations
  int8 per token, symmetric, ``amax / 127 + 1e-8``, on every projection;
- ``kv: "int4"``: every cached K and V row of 128 elements in int4 with
  its own scale and zero (``(max - min) / 15 + 1e-8``, ``min``, stored in
  bf16), quantized before any attention reads it; rows written after the
  prune (queries and answers) stay unquantized;
- ``embed: "int8"``: the embedding and the head, int8 per vocabulary row
  (``amax / 127 + 1e-8`` in bf16); the head takes int8 activations.

``precision`` picks the reference (``"f32"``) or a control one step below
what the configuration states: ``"fp8"`` runs every projection and the
head with e4m3 weights (a scale an output column) and e4m3 activations (a
scale a token); ``"a4"`` takes the quantized projections' and the head's
activations to int4 (``amax / 7``) in place of int8. ``"bf16"`` is a
witness, not a control: the projections' inputs and outputs and the K/V
rows rounded to bf16 before the stated formats apply, as a bf16 program
rounds them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-8
BF16 = torch.bfloat16
# attention logits held at once, float32 elements
ATTN_BLOCK = 1 << 30
# rows of an MLP block
MLP_ROWS = 8192


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------- quantizers
def fq_act(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-row symmetric integer rounding of activations (8 or 4 bits)."""
    top = 127.0 if bits == 8 else 7.0
    s = x.abs().amax(dim=-1, keepdim=True) / top + EPS
    return torch.clamp(torch.round(x / s), -top, top) * s


def fq_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """e4m3 rounding with one scale along ``dim`` (amax maps to 448)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fq_w4(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """(IN, OUT) weight through int4 per (group of input rows, column)."""
    IN, OUT = w.shape
    wg = w.reshape(IN // group, group, OUT)
    mn, mx = wg.amin(dim=1), wg.amax(dim=1)
    s = ((mx - mn) / 15.0 + EPS).to(BF16).float()
    z = mn.to(BF16).float()
    q = torch.clamp(torch.round((wg - z[:, None]) / s[:, None]), 0, 15)
    return (q * s[:, None] + z[:, None]).reshape(IN, OUT)


def fq_kv4(x: torch.Tensor) -> torch.Tensor:
    """(..., D) rows through int4 with one scale and zero a row."""
    mn, mx = x.amin(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)
    s = (mx - mn) / 15.0 + EPS
    q = torch.clamp(torch.round((x - mn) / s), 0, 15)
    return q * s.to(BF16).float() + mn.to(BF16).float()


def fq_rows8(w: torch.Tensor) -> torch.Tensor:
    """(V, D) table through int8, one scale a row."""
    s = (w.abs().amax(dim=-1, keepdim=True) / 127.0 + EPS).to(BF16).float()
    return torch.clamp(torch.round(w / s), -127, 127) * s


# ------------------------------------------------------------------ rope
def rope_of(model: dict) -> dict:
    """The configuration's rope: ``rope_theta`` and HF's ``rope_scaling``."""
    return {"theta": float(model["rope_theta"]), **(model.get("rope_scaling") or {})}


def inv_freq(rope: dict, dim: int) -> torch.Tensor:
    """Inverse frequencies, float64 then float32 (HF conventions); yarn
    with beta_fast 32 and beta_slow 1."""
    theta = float(rope["theta"])
    base = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim))
    kind = rope.get("rope_type", "default")
    if kind == "default":
        return base.float()
    if kind != "yarn":
        raise ValueError(f"rope type {kind!r}")
    factor, orig = float(rope["factor"]), float(rope["original_max_position_embeddings"])

    def find_dim(n_rot):
        return dim * math.log(orig / (n_rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(find_dim(32.0)), 0)
    high = min(math.ceil(find_dim(1.0)), dim // 2 - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / max(high - low, 1e-3)).clamp(0, 1)
    extra = 1.0 - ramp
    return (base / factor * (1 - extra) + base * extra).float()


def rope_tables(rope: dict, dim: int, pos: torch.Tensor) -> tuple:
    f = pos.double()[:, None] * inv_freq(rope, dim).double().to(pos.device)[None]
    emb = torch.cat([f, f], dim=-1)
    m = 0.1 * math.log(float(rope["factor"])) + 1.0 if rope.get("rope_type") == "yarn" else 1.0
    return (torch.cos(emb) * m).float(), (torch.sin(emb) * m).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


# ----------------------------------------------------------------- model
class RefModel:
    """The decoder of one configuration over the benchmark's bf16 tree."""

    def __init__(self, model: dict, quant: dict, weights: dict, precision: str = "f32"):
        no_tf32()
        if precision not in ("f32", "fp8", "a4", "bf16"):
            raise ValueError(f"precision {precision!r}")
        self.m, self.quant, self.w, self.precision = model, quant, weights, precision
        self.L = model["num_hidden_layers"]
        self.H = model["num_attention_heads"]
        self.Hkv = model["num_key_value_heads"]
        self.D = model["head_dim"]
        self.eps = float(model["rms_norm_eps"])
        self.scale = self.D ** -0.5
        self.w4 = quant.get("weights", "none") == "w4a8"
        self.kv4 = quant.get("kv", "none") == "int4"
        self.e8 = quant.get("embed", "none") == "int8"
        self._head = None

    # activations of a projection, as the configuration (or the control) rounds them
    def _act(self, x: torch.Tensor, quantized: bool) -> torch.Tensor:
        if self.precision == "bf16":
            x = x.to(BF16).float()
        if self.precision == "fp8":
            return fq_fp8(x, -1)
        if quantized:
            return fq_act(x, 4 if self.precision == "a4" else 8)
        return x

    def lin(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        y = self._act(x, self.w4) @ w
        y = y if b is None else y + b
        return y.to(BF16).float() if self.precision == "bf16" else y

    def layer(self, l: int) -> dict:
        """Layer l's weights in float32, projections through the stated
        (or the control's) weight format."""
        out = {}
        for k, v in self.w["layers"].items():
            t = v[l].float()
            if k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                if self.w4:
                    t = fq_w4(t)
                if self.precision == "fp8":
                    t = fq_fp8(t, 0)
            out[k] = t
        return out

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "bf16":
            x = x.to(BF16).float()
        return fq_kv4(x) if self.kv4 else x

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.w["embed"][ids].float()
        return fq_rows8(rows) if self.e8 else rows

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, self.w["final_norm"].float(), self.eps)
        if self._head is None:
            head = self.w.get("lm_head", self.w["embed"]).float()
            if self.e8:
                head = fq_rows8(head)
            if self.precision == "fp8":
                head = fq_fp8(head, 1)
            self._head = head
        return self._act(h, self.e8) @ self._head.T

    def qkv(self, x: torch.Tensor, w: dict, pos: torch.Tensor) -> tuple:
        """q (T, H, D), k and v (T, Hkv, D) of x after the layer's norm, with
        qk-norm and rope."""
        T = x.shape[0]
        h = rms_norm(x, w["ln_attn"], self.eps)
        q = self.lin(h, w["wq"], w.get("bq")).reshape(T, self.H, self.D)
        k = self.lin(h, w["wk"], w.get("bk")).reshape(T, self.Hkv, self.D)
        v = self.lin(h, w["wv"], w.get("bv")).reshape(T, self.Hkv, self.D)
        if "q_norm" in w:
            q, k = rms_norm(q, w["q_norm"], self.eps), rms_norm(k, w["k_norm"], self.eps)
        cos, sin = rope_tables(rope_of(self.m), self.D, pos)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def finish(self, x: torch.Tensor, o: torch.Tensor, w: dict) -> torch.Tensor:
        """The residual after attention output o (T, H, D), then the MLP,
        in blocks of rows."""
        x = x + self.lin(o.reshape(o.shape[0], -1), w["wo"])
        out = torch.empty_like(x)
        for r0 in range(0, x.shape[0], MLP_ROWS):
            xb = x[r0:r0 + MLP_ROWS]
            h = rms_norm(xb, w["ln_mlp"], self.eps)
            g = self.lin(h, w["w_gate"])
            u = self.lin(h, w["w_up"])
            out[r0:r0 + MLP_ROWS] = xb + self.lin(F.silu(g) * u, w["w_down"])
        return out


def attend(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, scale: float, mask_fn) -> torch.Tensor:
    """q (T, H, D) over K, V (Hkv, S, D), each kv head shared by its
    group of query heads; ``mask_fn(t0, t1)`` gives the visible keys of
    queries [t0, t1) as a bool mask broadcastable to (H, t1 - t0, S).
    Float32 ``scaled_dot_product_attention`` in blocks of queries (a block
    of logits stays within ``ATTN_BLOCK`` elements where the backend forms
    them)."""
    T, H, D = q.shape
    Hkv, S, _ = K.shape
    G = H // Hkv
    Ke = K.repeat_interleave(G, dim=0)[None]
    Ve = V.repeat_interleave(G, dim=0)[None]
    out = torch.empty_like(q)
    step = max(1, ATTN_BLOCK // (H * S))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        o = F.scaled_dot_product_attention(q[t0:t1].transpose(0, 1)[None], Ke, Ve,
                                           attn_mask=mask_fn(t0, t1)[None], scale=scale)
        out[t0:t1] = o[0].transpose(0, 1)
    return out
