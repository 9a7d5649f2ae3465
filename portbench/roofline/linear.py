"""Operations and bytes of the model's linears: the seven projections a
layer and the head, for T rows, in the format a configuration states
(bf16 weights; W4A8 int4 bytes with bf16 group scales and zeros; an int8
head with a bf16 scale a row), and the model's operations a token
(2 x the non-embedding parameters)."""

from __future__ import annotations

GROUP = 128


def shapes(m: dict) -> list:
    """(in, out) of a layer's seven projections."""
    D, I = m["hidden_size"], m["intermediate_size"]
    H, Hkv, Dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    return [(D, H * Dh), (D, Hkv * Dh), (D, Hkv * Dh), (H * Dh, D), (D, I), (D, I), (I, D)]


def params(m: dict) -> int:
    """Non-embedding parameters: the projections of every layer."""
    return m["num_hidden_layers"] * sum(i * o for i, o in shapes(m))


def weight_bytes(IN: int, OUT: int, w4: bool) -> int:
    if not w4:
        return 2 * IN * OUT
    return IN * OUT // 2 + 2 * 2 * (IN // GROUP) * OUT


def step_bound(m: dict, quant: dict, T: int, pk: dict) -> float:
    """The least time of a forward's linears and head over T rows (decode:
    T sequences of one token), seconds: each call's larger of operations
    over the peak of its format and bytes over the bandwidth, each weight
    byte read once and the activations in and out once."""
    w4 = quant.get("weights", "none") == "w4a8"
    bw = pk["hbm_bytes_per_s"]
    peak = pk["int8_ops"] if w4 else pk["bf16_flops"]
    total = 0.0
    for IN, OUT in shapes(m):
        nbytes = weight_bytes(IN, OUT, w4) + 2 * T * (IN + OUT)
        total += m["num_hidden_layers"] * max(2 * T * IN * OUT / peak, nbytes / bw)
    V, D = m["vocab_size"], m["hidden_size"]
    e8 = quant.get("embed", "none") == "int8"
    nbytes = (V * D + 2 * V if e8 else 2 * V * D) + 2 * T * (D + V)
    total += max(2 * T * V * D / (pk["int8_ops"] if e8 else pk["bf16_flops"]), nbytes / bw)
    return total
