"""The launch plan of K8 (``kvzip_tpu_torch/ops/w4a8_v2.py::plan``), which
mirrors ``csrc/w4a8.cu``: the CTAs' items cover every (token block, column
block, input group) once, the grid stays within ``occ`` CTAs an SM with no
idle CTA, one launch at T <= 4, and each output block's partials have one
fixed (split) order, one slot an item. The schedule (exact int32 group
sums scaled in float32 per group, the partials added in split order by
the last of them, the token scale last) is emulated in float32 and held
against K8's plain version, which scales the activations first: rtol =
atol = 1e-5 of the output's scale. K15/K16 run the same plan over the v1
storage's true groups (never a pad group), each group scaled by the v1
scale and zero as stored; that schedule is held against their plain
version (``ops/w4a8.py::_w4a8_jnp``) the same way.
"""

import pytest
import torch

from kvzip_tpu_torch.ops import w4a8_v2
from kvzip_tpu_torch.ops.quant import quantize_act_int8
from test_torch_engine import one_torch_thread  # noqa: F401

SMS = 132  # the H100's SM count

# qwen2.5-7b's four v2 linears, its int4 lm_head, no multiple of the column block
SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (3584, 152064),
          (384, 2336), (256, 640)]


@pytest.mark.parametrize("IN,OUT", SHAPES)
@pytest.mark.parametrize("T", [1, 3, 4, 5, 16, 24, 100, 256, 511])
def test_plan_covers_each_tile_once(IN, OUT, T):
    half, G = OUT // 2, IN // 128
    p = w4a8_v2.plan(T, half, G, SMS)
    assert p["inq"] == (T <= w4a8_v2.INQ_T)
    assert 1 <= p["grid"] <= p["occ"] * SMS and p["n_tb"] * 8 * p["nt"] >= T
    runs = w4a8_v2.cta_tiles(p)
    assert all(runs)                                    # no idle CTA
    tiles = [t for run in runs for t in run]
    assert sorted(tiles) == [(tb, cb, g) for tb in range(p["n_tb"])
                             for cb in range(p["n_cb"]) for g in range(G)]
    n_out = p["n_tb"] * p["n_cb"]
    items = [it for o in range(n_out) for it, _ in w4a8_v2.merge_order(p, o)]
    assert sorted(items) == list(range(n_out * p["S"]))     # a slot an item
    for o in range(n_out):
        order = w4a8_v2.merge_order(p, o)
        assert [it // n_out for it, _ in order] == list(range(p["S"]))   # split order
        for it, c in order:
            assert (o % p["n_tb"], o // p["n_tb"], (it // n_out) * p["gps"]) in runs[c]


def _emulate(x, w, p):
    """K8's schedule on one layer's v2 slice in float32 -> (T, OUT)."""
    xq, xs = quantize_act_int8(x)
    q = w["q4"] ^ 0x80
    IN, half = q.shape
    G, tb_n = IN // 128, 8 * p["nt"]
    nib = torch.cat([(q >> 4).int(), (q & 15).int()], dim=1)          # (IN, OUT)
    s2, z2 = w["s2"].float(), w["z2"].float()
    s = torch.cat([s2[0, :G] * 16.0, s2[1, :G]], dim=1)                 # (G, OUT)
    z = torch.cat([z2[0, :G] - 8.0 * s2[0, :G] * 16.0, z2[1, :G]], dim=1)
    T, OUT = x.shape[0], 2 * half
    out = torch.zeros(T, OUT)
    n_out = p["n_tb"] * p["n_cb"]
    partial = {}
    for c in range(p["grid"]):
        for it in range(c, n_out * p["S"], p["grid"]):
            split, o = divmod(it, n_out)
            tb, cb = o % p["n_tb"], o // p["n_tb"]
            toks = slice(tb * tb_n, min(T, (tb + 1) * tb_n))
            cols = torch.cat([torch.arange(cb * 128, min(half, cb * 128 + 128)) + h * half
                              for h in (0, 1)])
            f = None
            for g in range(split * p["gps"], min(G, (split + 1) * p["gps"])):
                xg = xq[toks, g * 128:(g + 1) * 128].int()
                acc = (xg @ nib[g * 128:(g + 1) * 128, cols]).float()      # exact in int32
                term = acc * s[g, cols] + xg.sum(1, keepdim=True).float() * z[g, cols]
                f = term if f is None else f + term
            order = w4a8_v2.merge_order(p, o)
            if len(order) == 1:
                out[toks, cols] = f * xs[toks]
                continue
            partial[it] = f
            if all(i in partial for i, _ in order):
                tot = partial[order[0][0]]
                for i, _ in order[1:]:
                    tot = tot + partial[i]
                out[toks, cols] = tot * xs[toks]
    return out


@pytest.mark.parametrize("IN,OUT,T,sms", [(384, 2336, 3, 132), (256, 640, 5, 4),
                                          (1024, 512, 17, 7), (128, 256, 40, 132)])
def test_schedule_reproduces_k8_plain(IN, OUT, T, sms):
    gen = torch.Generator().manual_seed(IN + T)
    w = torch.randn(1, IN, OUT, generator=gen) * 0.02
    from kvzip_tpu_torch.ops import w4a8

    v2 = w4a8_v2.repack_scales_v2(w4a8.quantize_weight_int4(w), in_dim=IN)
    v2 = {k: t[0] for k, t in v2.items()}
    x = torch.randn(T, IN, generator=gen)
    p = w4a8_v2.plan(T, OUT // 2, IN // 128, sms)
    got = _emulate(x, v2, p)
    want = w4a8_v2.w4a8_jnp_v2(x, v2)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


# K15/K16 run K8's body with the v1 scales, on the same plan over the true
# groups: qwen2.5-7b's seven unfused v1 linears (down's 148 groups stored
# as 160) and OUT/2 = 1,168, no multiple of the 128-column block.
V1_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (384, 2336)]


def _v1_weight(gen, IN, OUT):
    """One v1 weight as ``quantize_weight_int4`` stores it: random bytes in
    the true rows, zero pad rows and s = z = 0 on the pad groups."""
    from kvzip_tpu_torch.ops.w4a8 import _pad_groups

    G = IN // 128
    Gp = _pad_groups(G)
    q4 = torch.randint(0, 256, (Gp * 128, OUT // 2), dtype=torch.uint8, generator=gen)
    q4[IN:] = 0
    s = 0.0043 * (0.75 + 0.5 * torch.rand(Gp, OUT, generator=gen))
    s[G:] = 0
    return dict(q4=q4, s=s.to(torch.bfloat16), z=(-7.5 * s).to(torch.bfloat16))


@pytest.mark.parametrize("IN,OUT", V1_SHAPES)
@pytest.mark.parametrize("T", [1, 4, 5, 24, 511])
def test_v1_plan_reads_true_groups_once(IN, OUT, T):
    from kvzip_tpu_torch.ops.w4a8 import _pad_groups

    G = IN // 128
    p = w4a8_v2.plan(T, OUT // 2, G, SMS)
    tiles = [t for run in w4a8_v2.cta_tiles(p) for t in run]
    assert len(tiles) == len(set(tiles)) == p["n_tb"] * p["n_cb"] * G
    assert {g for _, _, g in tiles} == set(range(G))          # no pad group
    assert _pad_groups(G) > G or IN != 18944                  # down's pads exist, unread


def _emulate_v1(x, w, p):
    """K15's schedule on one v1 weight in float32 -> (T, OUT): the unit's
    exact int32 sums of the true nibbles, each group scaled by the v1
    scale and zero of its output column as stored, the partials added in
    split order by the last of them, the token scale last."""
    xq, xs = quantize_act_int8(x)
    T, IN = x.shape
    G, half = IN // 128, w["q4"].shape[1]
    q = w["q4"][:IN] ^ 0x80
    nib = torch.cat([(q >> 4).int(), (q & 15).int()], dim=1)          # (IN, OUT)
    s, z = w["s"][:G].float(), w["z"][:G].float()                     # (G, OUT)
    out = torch.zeros(T, 2 * half)
    n_out, tb_n = p["n_tb"] * p["n_cb"], 8 * p["nt"]
    partial = {}
    for c in range(p["grid"]):
        for it in range(c, n_out * p["S"], p["grid"]):
            split, o = divmod(it, n_out)
            tb, cb = o % p["n_tb"], o // p["n_tb"]
            toks = slice(tb * tb_n, min(T, (tb + 1) * tb_n))
            cols = torch.cat([torch.arange(cb * 128, min(half, cb * 128 + 128)) + h * half
                              for h in (0, 1)])
            f = None
            for g in range(split * p["gps"], min(G, (split + 1) * p["gps"])):
                xg = xq[toks, g * 128:(g + 1) * 128].int()
                acc = (xg @ nib[g * 128:(g + 1) * 128, cols]).float()
                term = acc * s[g, cols] + xg.sum(1, keepdim=True).float() * z[g, cols]
                f = term if f is None else f + term
            order = w4a8_v2.merge_order(p, o)
            if len(order) == 1:
                out[toks, cols] = f * xs[toks]
                continue
            partial[it] = f
            if all(i in partial for i, _ in order):
                tot = partial[order[0][0]]
                for i, _ in order[1:]:
                    tot = tot + partial[i]
                out[toks, cols] = tot * xs[toks]
    return out


@pytest.mark.parametrize("IN,OUT,T,sms", [(2304, 352, 1, 132), (2304, 352, 5, 132),
                                          (2304, 352, 24, 7), (256, 640, 4, 3),
                                          (384, 2336, 3, 132)])
def test_v1_schedule_reproduces_k15_plain(IN, OUT, T, sms):
    """Pad groups (2304 -> 32 groups stored) and OUT/2 no multiple of 128."""
    from kvzip_tpu_torch.ops import w4a8

    gen = torch.Generator().manual_seed(IN + OUT + T)
    w = _v1_weight(gen, IN, OUT)
    x = torch.randn(T, IN, generator=gen)
    p = w4a8_v2.plan(T, OUT // 2, IN // 128, sms)
    got = _emulate_v1(x, w, p)
    want = w4a8._w4a8_jnp(x, w)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
