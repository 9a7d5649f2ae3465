"""The roofline counts at one kernel's known shapes against the bounds of
the port's kernel table (PERF.md, NVIDIA H100 peaks): K1 at a 4,096-row
prefill chunk after 12,288 rows, K2 at a scoring chunk, K8's four W4A8
linears of a qwen2.5-7b decode layer."""

import pytest

from portbench.roofline import attention, bound_s, linear, peaks

PK = peaks("NVIDIA H100 80GB HBM3")
QWEN25 = {"hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 28,
          "num_attention_heads": 28, "num_key_value_heads": 4, "head_dim": 128,
          "vocab_size": 152064}


def ms(ops, nbytes, peak):
    return 1e3 * bound_s(ops, nbytes, peak, PK["hbm_bytes_per_s"])


def test_k1_prefill_chunk():
    ops, nb = attention.causal(28, 4, 128, 4096, 12288, False)
    assert ms(ops, nb, PK["bf16_flops"]) == pytest.approx(0.851, abs=5e-4)


def test_k2_scoring_chunk():
    # 2,060 valid repeat queries, a 160-row sink and a 2,000-row chunk
    ops, nb = attention.scores(28, 4, 128, 2060, 160, 2000)
    assert ms(ops, nb, PK["bf16_flops"]) == pytest.approx(0.0476, abs=1e-4)


def test_k8_decode_layer():
    one_layer = {**QWEN25, "num_hidden_layers": 1}
    total = sum(ms(2 * IN * OUT, linear.weight_bytes(IN, OUT, True) + 2 * (IN + OUT),
                   PK["int8_ops"]) for IN, OUT in linear.shapes(one_layer))
    assert total == pytest.approx(0.0372, abs=4e-4)


def test_decode_step_bound_is_the_weight_stream():
    q = {"weights": "w4a8", "embed": "int8"}
    b = linear.step_bound(QWEN25, q, 8, PK)
    w = sum(linear.weight_bytes(i, o, True) for i, o in linear.shapes(QWEN25)) * 28
    assert b >= w / PK["hbm_bytes_per_s"]
    assert b < 1.2 * (w + QWEN25["vocab_size"] * 3584 * 1.01) / PK["hbm_bytes_per_s"]


def test_pool_decode_counts_every_kept_row_once():
    ops, nb = attention.pool_decode(28, 4, 128, 1, 1000, [10, 20], True)
    assert ops == 4 * 128 * 7 * 1 * (1000 + 4 * (11 + 21))
    assert nb == 1000 * 2 * (64 + 8) + 2 * 2 * 4 * 32 * 128 + 2 * 2 * 2 * 28 * 128
