"""On the card: each CUDA kernel (K1-K16; K7 and K11 also in their
int8-attention mode, K3 and K7 also with one tail length per kv head, K5
in its decode and prefill forms)
against its plain version, on the same bf16 inputs (int4 rows with bf16 or float32 scales
for K5-K7, int4 weights with bf16 scales for K8, K15 and K16), the plain version
computed in float32.

Run on a machine with a card: ``python -m pytest -n 0 -m cuda
tests/test_torch_kernels.py``. Here (no card) every test skips.
Tolerance: ``kvzip_tpu_torch.ops.parity``, relative to the reference's
size: elementwise |got - want| <= rtol |want| + 0.02 RMS(want), with rtol
2^-7 on attention outputs (bf16 probabilities in the p.v product, bf16
output; K5-K7 also round their dequantized values to bf16, K8 its
output) and 2^-4 on scores (bf16-rounded logits), and RMS(got - want) <=
2^-7 RMS(want); K15/K16's bias is added to the bf16 output and rounded
again, as the plain version adds it. In the int8-attention mode the plain version repeats the
kernel's s8 arithmetic at its 64-row p tile and the integer sums are
exact, but a quantized p lying at a .5 boundary may round one step the
other way in the kernel's float32: the same gate holds it after
discounting the slack such flips could cause (``parity``'s ``slack``,
from the plain version's ``with_slack``), and a reference with one tile
dropped must fail.
K13/K14's int8 rows are held equal except for one step
on at most 1e-3 of the elements, their scales to 1e-5 relative
(``ops.quant_parity``: the kernels' sums and rsqrtf/expf/tanhf differ from
PyTorch's in the last bits, which moves a value on a rounding boundary
one step).
K10 and K11 (both modes) are also held with each segment's live rows
(``seg_rows``) on padding-heavy stacks, where a count short of the live
rows must give the reference without the rows past it; K14 in both its
forms (clusters at small T, one CTA a row at large T) at four row widths.
K13 runs on a grid sized to the card at T 1-4,097 and four widths, and
under a graph replay. The engine's captured decode loop (one decode step a
CUDA graph) gives the per-token loop's tokens, counters and launch counts
on bf16, quantized, fused, W8A8-KV4 and flat states, with an eos inside a
chunk of steps, and captures one step a state when two states alternate.
K16 also at the gemma3 hybrid's prefill and scoring rows (T 2,304, 4,096,
16,384); ``attend_ring`` with ``ring_append`` (gemma3's sliding layer)
replayed from a CUDA graph across the ring's end equals its eager run bit
for bit, and the captured decode step over a hybrid cache gives the
per-token loop's tokens, counters and rings.
K1-K7 also at a tensor-parallel rank's local head counts (14 over 2, 7
over 1), and an engine on a world-size-1 NCCL mesh captures its decode
step with the collectives inside the graph.
K12 (the fused W4A8 decode layer) goes through ``parity`` with the output
rtol on both outputs: its chained s8 quantizations may flip a value at a
rounding boundary, which moves later sums by one s8 step of one input;
a reference with one weight group or one column block dropped must fail.
"""

import pytest
import torch

from kvzip_tpu_torch.ops import (LAUNCHES, OUT_RTOL, SCORE_RTOL, flash, parity,
                                 pool_decode, quant_parity, ragged_decode,
                                 reset_launches, score_kernel)

pytestmark = pytest.mark.cuda
D = 128


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    reset_launches()
    return torch.Generator(device="cpu").manual_seed(0)


def _rn(gen, *shape):
    return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)


def _ok(got, want, rtol=OUT_RTOL, slack=None):
    r = parity(got, want, rtol, slack)
    assert r["ok"], r
    return True



def _drop_first_tile(plain, q, k, v, lens):
    """The plain version without the first 64 keys: a kernel that lost a
    tile. The gate must reject it."""
    return plain(q.float(), k[:, 64:].float(), v[:, 64:].float(),
                 (lens - 64).clamp_min(0), scale=D ** -0.5)


# base + T == C on head 0 where C - T == base; T = 200 and 48 are not
# multiples of the 128-query block; C = 300 is no multiple of the 128-key
# tile (the last tile reads past C); the kv heads' bases differ by 7
@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4), (32, 8)])
@pytest.mark.parametrize("T,C,base", [(48, 256, 100), (256, 1024, 0),
                                      (1024, 8192, 5000), (16, 512, 300),
                                      (200, 1024, 824), (2304, 4096, 1792),
                                      (100, 300, 180)])
def test_flash_kernel(gen, H, Hkv, T, C, base):
    q, k, v = _rn(gen, T, H, D), _rn(gen, Hkv, C, D), _rn(gen, Hkv, C, D)
    lens = torch.tensor([max(base - 7 * i, 0) for i in range(Hkv)],
                        dtype=torch.int32, device="cuda")
    got = flash.flash_attend(q, k, v, lens, scale=D ** -0.5)
    want = flash.flash_attend_plain(q.float(), k.float(), v.float(), lens,
                                    scale=D ** -0.5)
    assert _ok(got, want) and LAUNCHES["flash_attend"] == 1
    drop = _drop_first_tile(flash.flash_attend_plain, q, k, v, lens)
    assert not parity(got, drop, OUT_RTOL)["ok"]


def _single_row_live(S: int, lo: int) -> int:
    """The least live length >= lo whose K4 split plan has a split holding
    exactly one row."""
    return next(n for n in range(lo, lo + (1 << 16))
                if any(b - a == 1 for a, b in ragged_decode.split_bounds(n, S)))


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4), (32, 8)])
@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("lens_kind", ["ragged", "edges", "short"])
def test_ragged_decode_kernel(gen, H, Hkv, T, lens_kind):
    """"ragged": C = 4096, bases 3000 - 400 h. "edges": C = 4001 (no
    multiple of the 16-key tile or split unit), head 0 at base 0, head 1
    at base + T = C, head 2 with a split that holds a single live row.
    "short": C = 160, so fewer than 8 splits and fewer merging CTAs, each
    merging a wider column slice."""
    C = {"ragged": 4096, "edges": 4001, "short": 160}[lens_kind]
    q, k, v = _rn(gen, T, H, D), _rn(gen, Hkv, C, D), _rn(gen, Hkv, C, D)
    if lens_kind == "ragged":
        lens = [3000 - 400 * i for i in range(Hkv)]
    elif lens_kind == "short":
        lens = [C - T - 19 * i for i in range(Hkv)]
    else:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        S, _ = ragged_decode.plan_splits(C, Hkv, (H // Hkv) * T, sms)
        lens = [0, C - T] + [C // 2 - 37 * i for i in range(2, Hkv)]
        if Hkv > 2:
            lens[2] = _single_row_live(S, 1000) - T
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = ragged_decode.ragged_decode_attend(q, k, v, lens, scale=D ** -0.5)
    want = ragged_decode.ragged_decode_attend_plain(
        q.float(), k.float(), v.float(), lens, scale=D ** -0.5)
    assert _ok(got, want) and LAUNCHES["ragged_decode_attend"] == 1
    drop = _drop_first_tile(ragged_decode.ragged_decode_attend_plain, q, k, v, lens)
    assert not parity(got, drop, OUT_RTOL)["ok"]


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("ctx_len,q_valid", [(256, 300), (100, 200)])
def test_score_kernel(gen, H, Hkv, ctx_len, q_valid):
    sink, s_ctx, T = 37, 256, 320
    q, keys = _rn(gen, T, H, D), _rn(gen, Hkv, sink + s_ctx + T, D)
    kw = dict(sink=sink, s_ctx=s_ctx, scale=D ** -0.5,
              model_dtype=torch.bfloat16)
    got = score_kernel.fused_scores(q, keys, ctx_len, q_valid, **kw)
    want = score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len,
                                           q_valid, **kw)
    assert _ok(got, want, SCORE_RTOL) and LAUNCHES["fused_scores"] == 1


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_pool_decode_kernel(gen, H, Hkv, T):
    L, Tcap, tail_len = 3, 64, 7
    rows, off, P = [300, 0, 129], [0, 384, 512], 768
    rh = torch.full((P,), -1, dtype=torch.int32)
    for o, r in zip(off, rows):
        rh[o:o + r] = torch.randint(0, Hkv, (r,), generator=gen,
                                    dtype=torch.int32).sort().values
    q, kp, vp = _rn(gen, T, H, D), _rn(gen, P, D), _rn(gen, P, D)
    kt, vt = _rn(gen, L, Hkv, Tcap, D), _rn(gen, L, Hkv, Tcap, D)
    meta = (rh.cuda(), torch.tensor(off, dtype=torch.int32, device="cuda"),
            torch.tensor(rows, dtype=torch.int32, device="cuda"))
    for layer in range(L):
        got = pool_decode.pool_decode_attend(q, kp, vp, *meta, kt, vt, tail_len,
                                             layer, scale=D ** -0.5, max_rows=384)
        want = pool_decode.pool_decode_attend_plain(
            q.float(), kp.float(), vp.float(), *meta, kt.float(), vt.float(),
            tail_len, layer, scale=D ** -0.5)
        assert _ok(got, want)
    assert LAUNCHES["pool_decode_attend"] == L


def _quant(gen, *shape):
    """Random rows (..., D) as the int4 caches hold them (packed uint8,
    bf16 scale/zero), on the card."""
    from kvzip_tpu_torch.ops.quant import quantize_int4

    p, s, z = quantize_int4(torch.randn(*shape, D, generator=gen).to(torch.bfloat16),
                            pack="split")
    return p.cuda(), s[..., 0].cuda(), z[..., 0].cuda()


def _int4_drop_first(kv, n=64):
    """The int4 cache without its first n rows (each of k_q, k_s, ..., v_z)."""
    return tuple(a[:, n:] for a in kv)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("T,C,base", [(1, 1024, 700), (4, 4096, 3000),
                                      (16, 1024, 500), (48, 256, 100),
                                      (1024, 8192, 5000)])
def test_flash_int4_kernel(gen, H, Hkv, T, C, base):
    from kvzip_tpu_torch.ops import flash_int4

    q = _rn(gen, T, H, D)
    kv = (*_quant(gen, Hkv, C), *_quant(gen, Hkv, C))
    lens = torch.tensor([max(base - 7 * i, 0) for i in range(Hkv)],
                        dtype=torch.int32, device="cuda")
    got = flash_int4.flash_attend_int4(q, *kv, lens, scale=D ** -0.5)
    want = flash_int4.flash_attend_int4_plain(q.float(), *kv, lens, scale=D ** -0.5)
    assert _ok(got, want) and LAUNCHES["flash_attend_int4"] == 1
    drop = flash_int4.flash_attend_int4_plain(q.float(), *_int4_drop_first(kv),
                                              (lens - 64).clamp_min(0), scale=D ** -0.5)
    assert not parity(got, drop, OUT_RTOL)["ok"]


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("T,C,base", [(48, 256, 100), (320, 2048, 1500)])
def test_flash_int4_extra_kernel(gen, H, Hkv, T, C, base):
    from kvzip_tpu_torch.ops import flash_int4

    q = _rn(gen, T, H, D)
    kv = (*_quant(gen, Hkv, C), *_quant(gen, Hkv, C))
    extra = (*_quant(gen, T, Hkv), *_quant(gen, T, Hkv))
    lens = torch.tensor([max(base - 7 * i, 0) for i in range(Hkv)],
                        dtype=torch.int32, device="cuda")
    got = flash_int4.flash_attend_int4_extra(q, *kv, lens, *extra, scale=D ** -0.5)
    want = flash_int4.flash_attend_int4_extra_plain(q.float(), *kv, lens, *extra,
                                                    scale=D ** -0.5)
    assert _ok(got, want) and LAUNCHES["flash_attend_int4_extra"] == 1


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_pool_decode_int4_kernel(gen, H, Hkv, T):
    L, Tcap, tail_len = 3, 64, 7
    rows, off, P = [300, 0, 129], [0, 384, 512], 768
    rh = torch.full((P,), -1, dtype=torch.int32)
    for o, r in zip(off, rows):
        rh[o:o + r] = torch.randint(0, Hkv, (r,), generator=gen,
                                    dtype=torch.int32).sort().values
    kq, ks, kz = _quant(gen, P)
    vq, vs, vz = _quant(gen, P)
    pool = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())
    q, kt, vt = _rn(gen, T, H, D), _rn(gen, L, Hkv, Tcap, D), _rn(gen, L, Hkv, Tcap, D)
    meta = (rh.cuda(), torch.tensor(off, dtype=torch.int32, device="cuda"),
            torch.tensor(rows, dtype=torch.int32, device="cuda"))
    for layer in range(L):
        got = pool_decode.pool_decode_attend_int4(
            q, *pool, *meta, kt, vt, tail_len, layer, scale=D ** -0.5, max_rows=384)
        want = pool_decode.pool_decode_attend_int4_plain(
            q.float(), *pool, *meta, kt.float(), vt.float(), tail_len, layer,
            scale=D ** -0.5)
        assert _ok(got, want)
    assert LAUNCHES["pool_decode_attend_int4"] == L


@pytest.mark.parametrize("T", [1, 3, 16, 100])
@pytest.mark.parametrize("IN,OUT", [(256, 640), (384, 256)])
def test_w4a8_kernel(gen, T, IN, OUT):
    from kvzip_tpu_torch.ops import w4a8, w4a8_v2

    L = 2
    w = torch.randn(L, IN, OUT, generator=gen) * 0.02
    v2 = w4a8_v2.repack_scales_v2(w4a8.quantize_weight_int4(w), in_dim=IN)
    v2 = {k: t.cuda() for k, t in v2.items()}
    x = _rn(gen, T, IN)
    for layer in range(L):
        got = w4a8_v2.w4a8_matmul_stacked_v2(x, v2["q4"], v2["s2"], v2["z2"], layer)
        want = w4a8_v2.w4a8_jnp_v2(x.float(), {k: t[layer] for k, t in v2.items()})
        assert _ok(got, want)
    assert LAUNCHES["w4a8_matmul_stacked_v2"] == L


# The prefill form (T > SPLIT_T): T = 17 is the first T past SPLIT_T (a
# 128-query block of mostly padded rows); C = 300 is no multiple of the
# 128-key tile and C = 1001 no multiple of 8 (the scales' rows); head 0 has
# base + T == C; the kv heads' bases differ by 7. A reference without the
# first 64 keys must fail.
@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4), (32, 8)])
@pytest.mark.parametrize("T,C,base", [(17, 1024, 700), (200, 300, 100),
                                      (200, 1001, 801), (300, 2048, 1748)])
def test_flash_int4_prefill_kernel(gen, H, Hkv, T, C, base):
    from kvzip_tpu_torch.ops import flash_int4

    q = _rn(gen, T, H, D)
    kv = (*_quant(gen, Hkv, C), *_quant(gen, Hkv, C))
    lens = torch.tensor([base - 7 * i for i in range(Hkv)], dtype=torch.int32,
                        device="cuda")
    got = flash_int4.flash_attend_int4(q, *kv, lens, scale=D ** -0.5)
    want = flash_int4.flash_attend_int4_plain(q.float(), *kv, lens, scale=D ** -0.5)
    assert _ok(got, want) and LAUNCHES["flash_attend_int4"] == 1
    assert LAUNCHES["flash_attend_int4_decode"] == 0
    drop = flash_int4.flash_attend_int4_plain(q.float(), *_int4_drop_first(kv),
                                              (lens - 64).clamp_min(0),
                                              scale=D ** -0.5)
    assert not parity(got, drop, OUT_RTOL)["ok"]


def test_flash_int4_decode_form_is_counted(gen):
    from kvzip_tpu_torch.ops import flash_int4

    q = _rn(gen, 4, 4, D)
    kv = (*_quant(gen, 2, 512), *_quant(gen, 2, 512))
    lens = torch.tensor([300, 293], dtype=torch.int32, device="cuda")
    got = flash_int4.flash_attend_int4(q, *kv, lens, scale=D ** -0.5)
    want = flash_int4.flash_attend_int4_plain(q.float(), *kv, lens, scale=D ** -0.5)
    assert _ok(got, want)
    assert LAUNCHES["flash_attend_int4"] == LAUNCHES["flash_attend_int4_decode"] == 1


# K6 at T = 17 (one 128-query block, one chunk tile), T = 200 (the chunk's
# rows cross a tile edge; base no multiple of 128) and the scoring chunk's
# 2304; a reference without the cache's last 64 rows must fail.
# After ``compact`` or a head-level prune the kv heads' lengths lie far
# apart: half the heads at the sink's rows, half at ~16k.
FAR_SINK, FAR_C = 37, 16896


@pytest.mark.parametrize("H,Hkv", [(28, 4), (32, 8)])
@pytest.mark.parametrize("kernel,T", [("flash", 16), ("flash", 24), ("flash", 64),
                                      ("ragged", 1), ("ragged", 8), ("int4", 1), ("int4", 4)])
def test_kernels_with_far_apart_head_lengths(gen, kernel, T, H, Hkv):
    from kvzip_tpu_torch.ops import flash_int4

    q = _rn(gen, T, H, D)
    lens = torch.tensor([FAR_SINK if h % 2 else 16384 - 7 * h for h in range(Hkv)],
                        dtype=torch.int32, device="cuda")
    if kernel == "int4":
        kv = (*_quant(gen, Hkv, FAR_C), *_quant(gen, Hkv, FAR_C))
        got = flash_int4.flash_attend_int4(q, *kv, lens, scale=D ** -0.5)
        want = flash_int4.flash_attend_int4_plain(q.float(), *kv, lens, scale=D ** -0.5)
        drop = flash_int4.flash_attend_int4_plain(q.float(), *_int4_drop_first(kv),
                                                  (lens - 64).clamp_min(0), scale=D ** -0.5)
        assert LAUNCHES["flash_attend_int4_decode"] == 1
    else:
        fn, plain = ((flash.flash_attend, flash.flash_attend_plain) if kernel == "flash" else
                     (ragged_decode.ragged_decode_attend,
                      ragged_decode.ragged_decode_attend_plain))
        k, v = _rn(gen, Hkv, FAR_C, D), _rn(gen, Hkv, FAR_C, D)
        got = fn(q, k, v, lens, scale=D ** -0.5)
        want = plain(q.float(), k.float(), v.float(), lens, scale=D ** -0.5)
        drop = _drop_first_tile(plain, q, k, v, lens)
        assert LAUNCHES[fn.__name__] == 1
    assert _ok(got, want) and not parity(got, drop, OUT_RTOL)["ok"]


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4), (32, 8)])
@pytest.mark.parametrize("T,C,base", [(17, 512, 300), (200, 1000, 650),
                                      (2304, 4096, 1500)])
def test_flash_int4_extra_edges_kernel(gen, H, Hkv, T, C, base):
    from kvzip_tpu_torch.ops import flash_int4

    q = _rn(gen, T, H, D)
    kv = (*_quant(gen, Hkv, C), *_quant(gen, Hkv, C))
    extra = (*_quant(gen, T, Hkv), *_quant(gen, T, Hkv))
    lens = torch.tensor([base - 7 * i for i in range(Hkv)], dtype=torch.int32,
                        device="cuda")
    got = flash_int4.flash_attend_int4_extra(q, *kv, lens, *extra, scale=D ** -0.5)
    want, drop = (flash_int4.flash_attend_int4_extra_plain(q.float(), *kv, n, *extra,
                                                           scale=D ** -0.5)
                  for n in (lens, lens - 64))
    assert _ok(got, want) and LAUNCHES["flash_attend_int4_extra"] == 1
    assert not parity(got, drop, OUT_RTOL)["ok"]


def test_tma_wrappers_reject_misaligned_rows(gen):
    """K5's prefill form, K6 and K9 load through TMA: a tensor whose start is
    not 16-byte aligned raises before any launch."""
    from kvzip_tpu_torch.ops import flash_int4, windowed_attend

    T, H, Hkv, C = 32, 4, 2, 256
    q = _rn(gen, T, H, D)
    q_off = torch.empty(T * H * D + 1, dtype=torch.bfloat16, device="cuda")[1:].view(T, H, D)
    kv = (*_quant(gen, Hkv, C), *_quant(gen, Hkv, C))
    lens = torch.full((Hkv,), 100, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        flash_int4.flash_attend_int4(q_off, *kv, lens, scale=D ** -0.5)
    kq_off = torch.empty(Hkv * C * D // 2 + 8, dtype=torch.uint8,
                         device="cuda")[8:].view(Hkv, C, D // 2)
    with pytest.raises(ValueError, match="16-byte"):
        flash_int4.flash_attend_int4(q, kq_off, *kv[1:], lens, scale=D ** -0.5)
    extra = (*_quant(gen, T, Hkv), *_quant(gen, T, Hkv))
    x_off = torch.empty(T * Hkv * D // 2 + 8, dtype=torch.uint8,
                        device="cuda")[8:].view(T, Hkv, D // 2)
    with pytest.raises(ValueError, match="16-byte"):
        flash_int4.flash_attend_int4_extra(q, *kv, lens, x_off, *extra[1:], scale=D ** -0.5)
    keys = _rn(gen, Hkv, 8 + 64 + T, D)
    with pytest.raises(ValueError, match="16-byte"):
        windowed_attend.windowed_attend(q_off, keys, keys, 30, sink=8, s_ctx=64,
                                        scale=D ** -0.5)
    assert sum(LAUNCHES.values()) == 0


def test_quantized_wrappers_reject_wrong_dtypes(gen):
    """On the card a wrapper checks its operands before any launch: int4
    rows must be uint8, the dense cache's scales bf16, the pool's float32,
    the W4A8 bytes uint8."""
    from kvzip_tpu_torch.ops import flash_int4, w4a8_v2

    T, H, Hkv, C = 4, 4, 2, 256
    q = _rn(gen, T, H, D)
    kq, ks, kz = _quant(gen, Hkv, C)
    lens = torch.full((Hkv,), 100, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        flash_int4.flash_attend_int4(q, kq, ks.float(), kz, kq, ks, kz, lens,
                                     scale=D ** -0.5)
    with pytest.raises(TypeError, match="uint8"):
        flash_int4.flash_attend_int4(q, kq.to(torch.int8), ks, kz, kq, ks, kz, lens,
                                     scale=D ** -0.5)
    rh = torch.zeros((C,), dtype=torch.int32, device="cuda")
    off = torch.zeros((1,), dtype=torch.int32, device="cuda")
    tail = _rn(gen, 1, Hkv, 16, D)
    with pytest.raises(TypeError, match="float32"):
        pool_decode.pool_decode_attend_int4(
            q, kq[0], ks[0], kz[0], kq[0], ks[0], kz[0], rh, off, off + C, tail, tail,
            0, 0, scale=D ** -0.5, max_rows=C)
    x = _rn(gen, T, 256)
    s2 = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError, match="uint8"):
        w4a8_v2.w4a8_matmul_stacked_v2(
            x, torch.zeros((1, 256, 64), dtype=torch.int8, device="cuda"), s2, s2, 0)
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("H,Hkv", [(4, 2), (32, 8), (28, 4)])
@pytest.mark.parametrize("ctx_len,sink", [(256, 37), (100, 37), (200, 64)])
def test_windowed_attend_kernel(gen, H, Hkv, ctx_len, sink):
    from kvzip_tpu_torch.ops import windowed_attend

    T, s_ctx = 320, 256
    q = _rn(gen, T, H, D)
    keys, vals = _rn(gen, Hkv, sink + s_ctx + T, D), _rn(gen, Hkv, sink + s_ctx + T, D)
    kw = dict(sink=sink, s_ctx=s_ctx, scale=D ** -0.5)
    got = windowed_attend.windowed_attend(q, keys, vals, ctx_len, **kw)
    want = windowed_attend.windowed_attend_plain(q.float(), keys.float(), vals.float(),
                                                 ctx_len, **kw)
    assert _ok(got, want) and LAUNCHES["windowed_attend"] == 1
    if ctx_len > 64:  # one 64-key tile of the window left out must fail
        drop = windowed_attend.windowed_attend_plain(q.float(), keys.float(), vals.float(),
                                                     ctx_len - 64, **kw)
        assert not parity(got, drop, OUT_RTOL)["ok"]


# "blocks": T = 300 spans three 128-query blocks, the last one partly
# padded; the sink (37) is not tile-aligned. "pad": ctx_len 150 of s_ctx
# 768 leaves four whole 128-key tiles inside the dropped columns. "full":
# ctx_len == s_ctx (no pad), with a tile-aligned sink. A reference without
# the window's last 128 keys must fail.
@pytest.mark.parametrize("H,Hkv", [(32, 8), (28, 4), (16, 2)])
@pytest.mark.parametrize("T,s_ctx,ctx_len,sink", [(300, 512, 500, 37), (200, 768, 150, 37),
                                                  (260, 384, 384, 128), (129, 256, 200, 5)])
def test_windowed_attend_tiles_kernel(gen, H, Hkv, T, s_ctx, ctx_len, sink):
    from kvzip_tpu_torch.ops import windowed_attend

    q = _rn(gen, T, H, D)
    keys, vals = _rn(gen, Hkv, sink + s_ctx + T, D), _rn(gen, Hkv, sink + s_ctx + T, D)
    kw = dict(sink=sink, s_ctx=s_ctx, scale=D ** -0.5)
    got = windowed_attend.windowed_attend(q, keys, vals, ctx_len, **kw)
    want, drop = (windowed_attend.windowed_attend_plain(q.float(), keys.float(), vals.float(),
                                                        n, **kw)
                  for n in (ctx_len, ctx_len - 128))
    assert _ok(got, want) and LAUNCHES["windowed_attend"] == 1
    assert not parity(got, drop, OUT_RTOL)["ok"]


def _hold_quant(got, want):
    r = quant_parity(*got, *want)
    assert r["ok"], r
    s2 = want[1].clone()
    s2[0] *= 2  # one row's scale doubled must fail
    assert not quant_parity(*got, want[0], s2)["ok"]
    return True


@pytest.mark.parametrize("gemma", [False, True])
@pytest.mark.parametrize("T,W", [(1, 4096), (16, 4096), (300, 512), (3, 32768)])
def test_rmsnorm_quant_kernel(gen, gemma, T, W):
    from kvzip_tpu_torch.ops import fused_act

    x = _rn(gen, T, W) * 3
    w = (1 + 0.2 * torch.randn(W, generator=gen)).to("cuda", torch.bfloat16)
    got = fused_act.rmsnorm_quant(x, w, 1e-5, gemma=gemma)
    want = fused_act.rmsnorm_quant_plain(x, w, 1e-5, gemma=gemma)
    assert _hold_quant(got, want) and LAUNCHES["rmsnorm_quant"] == 1


@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh"])
@pytest.mark.parametrize("T,W", [(1, 14336), (16, 14336), (300, 1024), (2, 8)])
def test_silu_mul_quant_kernel(gen, act, T, W):
    from kvzip_tpu_torch.ops import fused_act

    gate, up = _rn(gen, T, W) * 3, _rn(gen, T, W)
    got = fused_act.silu_mul_quant(gate, up, act=act)
    want = fused_act.silu_mul_quant_plain(gate, up, act=act)
    assert _hold_quant(got, want) and LAUNCHES["silu_mul_quant"] == 1


def test_new_wrappers_reject_wrong_dtypes_and_shapes(gen):
    """K9, K13 and K14 check their operands before any launch: bf16 rows,
    row widths the kernels take, K9's key count and window length."""
    from kvzip_tpu_torch.ops import fused_act, windowed_attend

    x = _rn(gen, 4, 256)
    w = _rn(gen, 256)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_act.rmsnorm_quant(x.float(), w, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_act.rmsnorm_quant(x[:, :252].contiguous(), w[:252].contiguous(), 1e-5)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_act.silu_mul_quant(x, x.half())
    with pytest.raises(ValueError, match="rows"):
        fused_act.silu_mul_quant(x, x[:2])
    with pytest.raises(ValueError, match="at most"):
        fused_act.silu_mul_quant(_rn(gen, 1, 32776), _rn(gen, 1, 32776))
    q, keys = _rn(gen, 16, 4, D), _rn(gen, 2, 8 + 64 + 16, D)
    with pytest.raises(TypeError, match="bfloat16"):
        windowed_attend.windowed_attend(q, keys.float(), keys, 30, sink=8, s_ctx=64,
                                        scale=D ** -0.5)
    with pytest.raises(ValueError, match="bad shapes"):
        windowed_attend.windowed_attend(q, keys, keys, 30, sink=8, s_ctx=48, scale=D ** -0.5)
    with pytest.raises(ValueError, match="bad shapes"):
        windowed_attend.windowed_attend(q, keys, keys, 0, sink=8, s_ctx=64, scale=D ** -0.5)
    assert sum(LAUNCHES.values()) == 0


def _flat_rows(gen, L, n_seq, Hkv, R_seg):
    """row_head of a flat stack: per layer and sequence each kv head's rows
    head-major from the segment's start (global ids), then padding."""
    rh = torch.full((L, n_seq * R_seg), -1, dtype=torch.int32)
    for l in range(L):
        for sb in range(n_seq):
            counts = torch.randint(64, R_seg // Hkv, (Hkv,), generator=gen)
            ids = torch.repeat_interleave(torch.arange(Hkv, dtype=torch.int32) + sb * Hkv,
                                          counts)
            rh[l, sb * R_seg:sb * R_seg + len(ids)] = ids
    return rh.cuda()


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("n_seq,T", [(1, 1), (1, 24), (2, 4)])
@pytest.mark.parametrize("kind", ["bf16", "int4", "int4_q8"])
def test_flat_decode_kernels(gen, H, Hkv, n_seq, T, kind):
    """K10 (bf16), K11 and K11-q8 on a stacked flat cache, every layer, a
    per-head tail length for merged batches; one 64-row tile dropped from
    the reference must fail."""
    from kvzip_tpu_torch.ops import flat_decode

    L, R_seg, Tcap = 2, 1024, 64
    rh = _flat_rows(gen, L, n_seq, Hkv, R_seg)
    q = _rn(gen, T, n_seq * H, D)
    kt, vt = _rn(gen, n_seq * Hkv, Tcap, D), _rn(gen, n_seq * Hkv, Tcap, D)
    tl = (torch.randint(0, Tcap - T, (n_seq * Hkv,), generator=gen, dtype=torch.int32).cuda()
          if n_seq > 1 else 7)
    kw = dict(scale=D ** -0.5, n_seq=n_seq)
    if kind == "bf16":
        k, v = _rn(gen, L, n_seq * R_seg, D), _rn(gen, L, n_seq * R_seg, D)
        run = lambda r, layer: flat_decode.flat_decode_attend(q, k, v, r, kt, vt, tl,
                                                              layer=layer, **kw)
        ref = lambda r, layer: (flat_decode.flat_decode_attend_plain(
            q.float(), k.float(), v.float(), r, kt.float(), vt.float(), tl, layer=layer,
            **kw), None)
        name = "flat_decode_attend"
    else:
        q8 = kind == "int4_q8"
        kq, ks, kz = _quant(gen, L, n_seq * R_seg)
        vq, vs, vz = _quant(gen, L, n_seq * R_seg)
        flat = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())
        run = lambda r, layer: flat_decode.flat_decode_attend_int4(
            q, *flat, r, kt, vt, tl, q8=q8, layer=layer, **kw)

        def ref(r, layer):
            out = flat_decode.flat_decode_attend_int4_plain(
                q.float(), *flat, r, kt.float(), vt.float(), tl, q8=q8, layer=layer,
                with_slack=q8, **kw)
            return out if q8 else (out, None)
        name = "flat_decode_attend_int4_q8" if q8 else "flat_decode_attend_int4"
    for layer in range(L):
        got = run(rh, layer)
        want, slack = ref(rh, layer)
        assert _ok(got, want, slack=slack)
    rh_drop = rh.clone()
    rh_drop[L - 1, :64] = -1
    drop, slack = ref(rh_drop, L - 1)
    assert not parity(got, drop, OUT_RTOL, slack)["ok"]
    assert LAUNCHES[name] == L and sum(LAUNCHES.values()) == L


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_pool_decode_int4_q8_kernel(gen, H, Hkv, T):
    L, Tcap, tail_len = 3, 64, 7
    rows, off, P = [300, 0, 129], [0, 384, 512], 768
    rh = torch.full((P,), -1, dtype=torch.int32)
    for o, r in zip(off, rows):
        rh[o:o + r] = torch.randint(0, Hkv, (r,), generator=gen,
                                    dtype=torch.int32).sort().values
    kq, ks, kz = _quant(gen, P)
    vq, vs, vz = _quant(gen, P)
    pool = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())
    q, kt, vt = _rn(gen, T, H, D), _rn(gen, L, Hkv, Tcap, D), _rn(gen, L, Hkv, Tcap, D)
    geo = (torch.tensor(off, dtype=torch.int32, device="cuda"),
           torch.tensor(rows, dtype=torch.int32, device="cuda"))
    for layer in range(L):
        got = pool_decode.pool_decode_attend_int4(
            q, *pool, rh.cuda(), *geo, kt, vt, tail_len, layer, scale=D ** -0.5, max_rows=384,
            q8=True)
        want, slack = pool_decode.pool_decode_attend_int4_plain(
            q.float(), *pool, rh.cuda(), *geo, kt.float(), vt.float(), tail_len, layer,
            scale=D ** -0.5, q8=True, with_slack=True)
        assert _ok(got, want, slack=slack)
    rh_drop = rh.clone()
    rh_drop[:64] = -1
    drop, slack = pool_decode.pool_decode_attend_int4_plain(
        q.float(), *pool, rh_drop.cuda(), *geo, kt.float(), vt.float(), tail_len, 0,
        scale=D ** -0.5, q8=True, with_slack=True)
    got0 = pool_decode.pool_decode_attend_int4(
        q, *pool, rh.cuda(), *geo, kt, vt, tail_len, 0, scale=D ** -0.5, max_rows=384, q8=True)
    assert not parity(got0, drop, OUT_RTOL, slack)["ok"]
    assert LAUNCHES["pool_decode_attend_int4_q8"] == L + 1
    assert LAUNCHES["pool_decode_attend_int4"] == 0


def test_flat_wrappers_reject_wrong_dtypes_and_shapes(gen):
    """K10 and K11 check their operands before any launch."""
    from kvzip_tpu_torch.ops import flat_decode

    q = _rn(gen, 1, 4, D)
    k = _rn(gen, 2, 128, D)
    rh = torch.zeros((2, 128), dtype=torch.int32, device="cuda")
    kt = _rn(gen, 2, 16, D)
    with pytest.raises(TypeError, match="bfloat16"):
        flat_decode.flat_decode_attend(q, k.float(), k, rh, kt, kt, 0, scale=1.0, layer=0)
    with pytest.raises(ValueError, match="bad shapes"):
        flat_decode.flat_decode_attend(q, k, k, rh[:, :64].contiguous(), kt, kt, 0, scale=1.0,
                                       layer=0)
    with pytest.raises(ValueError, match="tail_len"):
        flat_decode.flat_decode_attend(q, k, k, rh, kt, kt, 16, scale=1.0, layer=0)
    kq, ks, kz = _quant(gen, 2, 128)
    with pytest.raises(TypeError, match="float32"):
        flat_decode.flat_decode_attend_int4(q, kq, ks, kz, kq, ks, kz, rh, kt, kt, 0,
                                            scale=1.0, layer=0)
    with pytest.raises(ValueError, match="tail_len"):
        flat_decode.flat_decode_attend_int4(
            q, kq, ks.float(), kz.float(), kq, ks.float(), kz.float(), rh, kt, kt,
            torch.zeros((3,), dtype=torch.int32, device="cuda"), scale=1.0, layer=0)
    assert sum(LAUNCHES.values()) == 0


def _pool_geometry(gen, Hkv):
    rows, off, P = [300, 0, 129], [0, 384, 512], 768
    rh = torch.full((P,), -1, dtype=torch.int32)
    for o, r in zip(off, rows):
        rh[o:o + r] = torch.randint(0, Hkv, (r,), generator=gen,
                                    dtype=torch.int32).sort().values
    return (rh.cuda(), torch.tensor(off, dtype=torch.int32, device="cuda"),
            torch.tensor(rows, dtype=torch.int32, device="cuda")), P


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("kind", ["bf16", "int4", "int4_q8"])
def test_pool_decode_kernels_with_per_head_tails(gen, kind, T):
    """K3, K7 and K7-q8 with one tail length per kv head (one of them 0) on
    every layer of a pool whose middle layer holds no rows; a vector of
    equal entries gives the scalar's bits."""
    H, Hkv, L, Tcap = 28, 4, 3, 64
    meta, P = _pool_geometry(gen, Hkv)
    q, kt, vt = _rn(gen, T, H, D), _rn(gen, L, Hkv, Tcap, D), _rn(gen, L, Hkv, Tcap, D)
    tails = torch.tensor([7, 0, 41, 19], dtype=torch.int32, device="cuda")
    if kind == "bf16":
        pool = (_rn(gen, P, D), _rn(gen, P, D))
        fn, plain, name = (pool_decode.pool_decode_attend, pool_decode.pool_decode_attend_plain,
                           "pool_decode_attend")
        kw = {}
    else:
        kq, ks, kz = _quant(gen, P)
        vq, vs, vz = _quant(gen, P)
        pool = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())
        fn, plain = pool_decode.pool_decode_attend_int4, pool_decode.pool_decode_attend_int4_plain
        q8 = kind == "int4_q8"
        name = "pool_decode_attend_int4_q8" if q8 else "pool_decode_attend_int4"
        kw = dict(q8=q8)
    for layer in range(L):
        got = fn(q, *pool, *meta, kt, vt, tails, layer, scale=D ** -0.5, max_rows=384, **kw)
        want = plain(q.float(), *pool, *meta, kt.float(), vt.float(), tails, layer,
                     scale=D ** -0.5, **kw, **(dict(with_slack=True) if kw.get("q8") else {}))
        want, slack = want if kw.get("q8") else (want, None)
        assert _ok(got, want, slack=slack)
    same = [fn(q, *pool, *meta, kt, vt, tl, 0, scale=D ** -0.5, max_rows=384, **kw)
            for tl in (9, torch.full((Hkv,), 9, dtype=torch.int32, device="cuda"))]
    assert torch.equal(same[0], same[1])
    assert LAUNCHES[name] == L + 2
    with pytest.raises(ValueError, match="tail_len"):
        fn(q, *pool, *meta, kt, vt, torch.tensor([7, 0, Tcap - T + 1, 19], dtype=torch.int32,
                                                 device="cuda"), 0, scale=D ** -0.5,
           max_rows=384, **kw)


# K7 and K11 since their one-launch redesign: cases that reach the planned
# splits, the in-launch merge and the q8 tiles from every side.
ONE_LAUNCH_CASES = [
    ("pool", "unsorted"), ("flat", "unsorted"),
    ("pool", "few_rows"), ("flat", "few_rows"),
    ("pool", "tile_edges"), ("flat", "tile_edges"),
    ("pool", "tail_vector"), ("flat", "tail_vector"),
    ("flat", "n_seq2"),
    ("pool", "T16"), ("flat", "T16"), ("pool", "T24"), ("flat", "T24"),
    ("pool", "graph"), ("flat", "graph"),
]


def _segment_heads(gen, case, n, Hkv):
    """The kv head of each of a segment's n rows: "unsorted" a random order
    over all but the last kv head (which holds no row); "tile_edges" head
    runs of 37, 0, 901 and the rest, so head boundaries fall inside 64-row
    tiles; otherwise sorted."""
    if case == "unsorted":
        return torch.randint(0, Hkv - 1, (n,), generator=gen, dtype=torch.int32)
    if case == "tile_edges":
        counts = torch.tensor([37, 0, 901, n - 938])
        return torch.repeat_interleave(torch.arange(Hkv, dtype=torch.int32), counts)
    return torch.randint(0, Hkv, (n,), generator=gen, dtype=torch.int32).sort().values


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("kind,case", ONE_LAUNCH_CASES)
def test_int4_decode_one_launch(gen, kind, case, q8):
    """K7 (pool) and K11 (flat), exact and q8, each one launch: an unsorted
    row_head with a kv head absent; a layer of 70 rows where the plan (from
    21,056 rows) has 83 splits; head boundaries inside 64-row tiles and, on
    the pool, a layer offset of 37 rows (the q8 tiles start at the
    segment's row 0); one tail length a kv head (0 and Tcap - T among
    them); K11 with two sequences; T 16 and 24 (more row groups); and a
    CUDA-graph capture with a tail vector. The reference without the
    segment's first 64 rows must fail the gate."""
    from kvzip_tpu_torch.ops import flat_decode, int4_decode

    H, Hkv, Tcap = 28, 4, 64
    T = {"T16": 16, "T24": 24}.get(case, 1)
    n_seq = 2 if case == "n_seq2" else 1
    n, max_rows = (70, 21056) if case == "few_rows" else (1500, 2048)
    if case in ("tail_vector", "graph", "n_seq2"):
        tails = torch.tensor([0, 9, Tcap - T, 23] * n_seq, dtype=torch.int32, device="cuda")
    else:
        tails = 7
    q = _rn(gen, T, n_seq * H, D)
    name = ("pool_decode_attend_int4" if kind == "pool" else "flat_decode_attend_int4") + \
        ("_q8" if q8 else "")
    if kind == "pool":
        off = 37 if case == "tile_edges" else 64
        P = off + max_rows
        rh = torch.full((P,), -1, dtype=torch.int32)
        rh[off:off + n] = _segment_heads(gen, case, n, Hkv)
        kv = (*_quant(gen, P), *_quant(gen, P))
        kv = (kv[0], kv[1].float(), kv[2].float(), kv[3], kv[4].float(), kv[5].float())
        kt, vt = _rn(gen, 1, Hkv, Tcap, D), _rn(gen, 1, Hkv, Tcap, D)
        geo = (torch.tensor([off], dtype=torch.int32, device="cuda"),
               torch.tensor([n], dtype=torch.int32, device="cuda"))

        def run():
            return pool_decode.pool_decode_attend_int4(q, *kv, rh_d, *geo, kt, vt, tails, 0,
                                                       scale=D ** -0.5, max_rows=max_rows, q8=q8)

        def plain(r):
            out = pool_decode.pool_decode_attend_int4_plain(
                q.float(), *kv, r.cuda(), *geo, kt.float(), vt.float(), tails, 0,
                scale=D ** -0.5, q8=q8, with_slack=q8)
            return out if q8 else (out, None)

        first = off
    else:
        L, R_seg = 2, max_rows
        rh = torch.full((L, n_seq * R_seg), -1, dtype=torch.int32)
        for sb in range(n_seq):
            rh[1, sb * R_seg:sb * R_seg + n] = _segment_heads(gen, case, n, Hkv) + sb * Hkv
        kv = (*_quant(gen, L, n_seq * R_seg), *_quant(gen, L, n_seq * R_seg))
        kv = (kv[0], kv[1].float(), kv[2].float(), kv[3], kv[4].float(), kv[5].float())
        kt, vt = _rn(gen, n_seq * Hkv, Tcap, D), _rn(gen, n_seq * Hkv, Tcap, D)

        def run():
            return flat_decode.flat_decode_attend_int4(q, *kv, rh_d, kt, vt, tails,
                                                       scale=D ** -0.5, q8=q8, n_seq=n_seq,
                                                       layer=1)

        def plain(r):
            out = flat_decode.flat_decode_attend_int4_plain(
                q.float(), *kv, r.cuda(), kt.float(), vt.float(), tails, scale=D ** -0.5, q8=q8,
                n_seq=n_seq, layer=1, with_slack=q8)
            return out if q8 else (out, None)

        first = None
    rh_d = rh.cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mtc, groups, S = int4_decode.plan(H * T, n_seq, max_rows, sms)
    if case == "few_rows":
        assert S * int4_decode.ROW_TILE > n
    if case == "graph":
        run()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            got = run()
        g.replay()
        torch.cuda.synchronize()
    else:
        got = run()
    want, slack = plain(rh)
    assert _ok(got, want, slack=slack)
    rh_drop = rh.clone()
    if first is None:
        rh_drop[1, :64] = -1
    else:
        rh_drop[first:first + 64] = -1
    drop, slack = plain(rh_drop)
    assert not parity(got, drop, OUT_RTOL, slack)["ok"]
    assert LAUNCHES[name] == (2 if case == "graph" else 1)
    assert sum(LAUNCHES.values()) == LAUNCHES[name]


def _fused_weights(gen, L, D_, HD, I, QKV):
    from kvzip_tpu_torch.ops import w4a8, w4a8_v2

    def stack(IN, OUT):
        w = torch.randn(L, IN, OUT, generator=gen) * 0.05
        return {k: t.cuda() for k, t in
                w4a8_v2.repack_scales_v2(w4a8.quantize_weight_int4(w), in_dim=IN).items()}

    return stack(HD, D_), stack(D_, 2 * I), stack(I, D_), stack(D_, QKV)


FUSED = dict(L=3, D_=512, HD=512, I=1024, QKV=768)


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("T", [1, 4, 8])
def test_w4a8_layer_fused_kernel(gen, T, layer):
    from kvzip_tpu_torch.ops import w4a8_fused

    ws = _fused_weights(gen, **FUSED)
    L, D_ = FUSED["L"], FUSED["D_"]
    x, attn = _rn(gen, T, D_) * 0.3, _rn(gen, T, FUSED["HD"]) * 0.3
    lnm, lna = 1 + 0.1 * _rn(gen, L, D_), 1 + 0.1 * _rn(gen, L, D_)
    got = w4a8_fused.w4a8_layer_fused(x, attn, lnm, lna, *ws, layer, eps=1e-6)
    want = w4a8_fused.w4a8_layer_fused_plain(x, attn, lnm, lna, *ws, layer, eps=1e-6)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _ok(g, w)
    assert LAUNCHES["w4a8_layer_fused"] == 1


def test_w4a8_layer_fused_gate_rejects_dropped_group_and_block(gen):
    """The hold fails for a reference whose qkv weights lack one input
    group, and for one whose o-proj lacks a 128-column block."""
    from kvzip_tpu_torch.ops import w4a8_fused

    ws = _fused_weights(gen, **FUSED)
    L, D_ = FUSED["L"], FUSED["D_"]
    x, attn = _rn(gen, 4, D_) * 0.3, _rn(gen, 4, FUSED["HD"]) * 0.3
    lnm, lna = 1 + 0.1 * _rn(gen, L, D_), 1 + 0.1 * _rn(gen, L, D_)
    x_new, qkv = w4a8_fused.w4a8_layer_fused(x, attn, lnm, lna, *ws, 1, eps=1e-6)
    wo, wgu, wdn, wqkv = ({k: t.clone() for k, t in w.items()} for w in ws)
    for k in ("s2", "z2"):
        wqkv[k][1, :, 2] = 0    # input group 2 of layer 1
        wo[k][1, 0, :, :128] = 0  # o-proj output columns 0..127
    _, qkv_drop = w4a8_fused.w4a8_layer_fused_plain(x, attn, lnm, lna, *ws[:3], wqkv, 1,
                                                    eps=1e-6)
    x_drop, _ = w4a8_fused.w4a8_layer_fused_plain(x, attn, lnm, lna, wo, *ws[1:], 1, eps=1e-6)
    assert not parity(qkv, qkv_drop, OUT_RTOL)["ok"]
    assert not parity(x_new, x_drop, OUT_RTOL)["ok"]


def test_w4a8_layer_fused_rejects_wrong_dtypes_and_shapes(gen):
    from kvzip_tpu_torch.ops import w4a8_fused

    ws = _fused_weights(gen, **FUSED)
    L, D_ = FUSED["L"], FUSED["D_"]
    ln = torch.ones((L, D_), dtype=torch.bfloat16, device="cuda")
    x, attn = _rn(gen, 4, D_), _rn(gen, 4, FUSED["HD"])
    with pytest.raises(TypeError, match="bfloat16"):
        w4a8_fused.w4a8_layer_fused(x.float(), attn, ln, ln, *ws, 0, eps=1e-6)
    bad = dict(ws[0], q4=ws[0]["q4"].view(torch.int8))
    with pytest.raises(TypeError, match="uint8"):
        w4a8_fused.w4a8_layer_fused(x, attn, ln, ln, bad, *ws[1:], 0, eps=1e-6)
    with pytest.raises(ValueError, match="1..8"):
        w4a8_fused.w4a8_layer_fused(_rn(gen, 9, D_), _rn(gen, 9, FUSED["HD"]), ln, ln, *ws,
                                    0, eps=1e-6)
    with pytest.raises(ValueError, match="does not fit"):
        w4a8_fused.w4a8_layer_fused(x, attn, ln, ln, ws[0], ws[3], *ws[2:], 0, eps=1e-6)
    assert sum(LAUNCHES.values()) == 0


def _v1_stack(gen, L, IN, OUT):
    """A v1 W4A8 stack of N(0, 0.02) weights (pad groups where IN / 128 is
    not a multiple of the reference's 16 groups a block), on the card."""
    from kvzip_tpu_torch.ops import w4a8

    w = torch.randn(L, IN, OUT, generator=gen) * 0.02
    return {k: t.cuda() for k, t in w4a8.quantize_weight_int4(w).items()}


@pytest.mark.parametrize("T", [1, 4, 5, 24, 511])
@pytest.mark.parametrize("IN,OUT", [(2304, 256), (256, 640), (128, 512), (256, 10240)])
def test_w4a8_v1_stacked_kernel(gen, T, IN, OUT):
    """K15 at every layer of a 3-layer stack: pad groups (2304 -> 32
    groups), one input group, OUT/2 = 320 (no multiple of the 128-column
    block), one launch (T <= 4) and two (T >= 5), and a grid of one split
    beside several."""
    from kvzip_tpu_torch.ops import w4a8

    L = 3
    w = _v1_stack(gen, L, IN, OUT)
    x = _rn(gen, T, IN)
    for layer in range(L):
        got = w4a8.w4a8_matmul_stacked(x, w["q4"], w["s"], w["z"], layer)
        want = w4a8._w4a8_jnp(x.float(), {k: t[layer] for k, t in w.items()})
        assert got.dtype == torch.bfloat16 and got.shape == (T, OUT)
        assert _ok(got, want)
    assert LAUNCHES["w4a8_matmul_stacked"] == L and LAUNCHES["w4a8_matmul"] == 0


@pytest.mark.parametrize("T", [1, 24])
@pytest.mark.parametrize("IN,OUT", [(2304, 256), (256, 640)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_w4a8_v1_kernel_with_bias(gen, T, IN, OUT, with_bias):
    """K16 on one weight, its bias added after the cast to bf16."""
    from kvzip_tpu_torch.ops import w4a8

    w = {k: t[0] for k, t in _v1_stack(gen, 1, IN, OUT).items()}
    x = _rn(gen, T, IN)
    bias = _rn(gen, OUT) if with_bias else None
    got = w4a8.w4a8_matmul(x, w["q4"], w["s"], w["z"], bias)
    want = w4a8._w4a8_jnp(x.float(), w)
    if with_bias:
        want = want.to(torch.bfloat16).float() + bias.float()
    assert _ok(got, want)
    assert LAUNCHES["w4a8_matmul"] == 1 and LAUNCHES["w4a8_matmul_stacked"] == 0


def test_w4a8_v1_gate_rejects_a_dropped_group(gen):
    from kvzip_tpu_torch.ops import w4a8

    w = _v1_stack(gen, 2, 2304, 256)
    x = _rn(gen, 1, 2304)
    got = w4a8.w4a8_matmul_stacked(x, w["q4"], w["s"], w["z"], 1)
    xd = x.float().clone()
    xd[:, 128:256] = 0  # input group 1
    assert not parity(got, w4a8._w4a8_jnp(xd, {k: t[1] for k, t in w.items()}),
                      OUT_RTOL)["ok"]


def _replays(run):
    """run() eagerly, then captured in a CUDA graph and replayed twice: the
    eager output and each replay's."""
    def tup(o):
        return o if isinstance(o, tuple) else (o,)

    eager = tuple(t.clone() for t in tup(run()))
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tup(run())
    g.replay()
    torch.cuda.synchronize()
    first = tuple(t.clone() for t in out)
    g.replay()
    torch.cuda.synchronize()
    return eager, first, out


@pytest.mark.parametrize("T", [1, 5, 24])
@pytest.mark.parametrize("bias", [False, True])
def test_w4a8_v1_repeat_and_graph(gen, T, bias):
    """K15 (and K16 with a bias): two calls give the same bits, and two
    replays of a captured CUDA graph equal the eager call."""
    from kvzip_tpu_torch.ops import w4a8

    w = _v1_stack(gen, 2, 2304, 640)
    x = _rn(gen, T, 2304)
    b = _rn(gen, 640) if bias else None

    def run():
        if bias:
            return w4a8.w4a8_matmul(x, w["q4"][1], w["s"][1], w["z"][1], b)
        return w4a8.w4a8_matmul_stacked(x, w["q4"], w["s"], w["z"], 1)

    assert torch.equal(run(), run())
    eager, first, second = _replays(run)
    assert torch.equal(eager[0], first[0]) and torch.equal(first[0], second[0])


@pytest.mark.parametrize("T", list(range(1, 9)))
def test_w4a8_layer_fused_every_t(gen, T):
    """K12 at every T of its range, with the next layer's qkv slice as the
    forward passes it."""
    from kvzip_tpu_torch.ops import w4a8_fused

    ws = _fused_weights(gen, **FUSED)
    L, D_ = FUSED["L"], FUSED["D_"]
    x, attn = _rn(gen, T, D_) * 0.3, _rn(gen, T, FUSED["HD"]) * 0.3
    lnm, lna = 1 + 0.1 * _rn(gen, L, D_), 1 + 0.1 * _rn(gen, L, D_)
    got = w4a8_fused.w4a8_layer_fused(x, attn, lnm, lna, *ws, 1, eps=1e-6, qkv_layer=2)
    want = w4a8_fused.w4a8_layer_fused_plain(x, attn, lnm, lna, *ws, 1, eps=1e-6,
                                             qkv_layer=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        assert _ok(g, w)
    assert LAUNCHES["w4a8_layer_fused"] == 1


@pytest.mark.parametrize("T", [1, 8])
def test_w4a8_layer_fused_repeat_and_graph(gen, T):
    """K12: two calls give the same bits, and two replays of a captured
    CUDA graph (one cooperative launch) equal the eager call."""
    from kvzip_tpu_torch.ops import w4a8_fused

    ws = _fused_weights(gen, **FUSED)
    L, D_ = FUSED["L"], FUSED["D_"]
    x, attn = _rn(gen, T, D_) * 0.3, _rn(gen, T, FUSED["HD"]) * 0.3
    lnm, lna = 1 + 0.1 * _rn(gen, L, D_), 1 + 0.1 * _rn(gen, L, D_)

    def run():
        return w4a8_fused.w4a8_layer_fused(x, attn, lnm, lna, *ws, 0, eps=1e-6, qkv_layer=1)

    a, b = run(), run()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    eager, first, second = _replays(run)
    for e, f, s in zip(eager, first, second):
        assert torch.equal(e, f) and torch.equal(f, s)


def test_w4a8_v1_rejects_wrong_dtypes_and_shapes(gen):
    from kvzip_tpu_torch.ops import w4a8

    w = _v1_stack(gen, 2, 256, 256)
    x = _rn(gen, 4, 256)
    with pytest.raises(TypeError, match="bfloat16"):
        w4a8.w4a8_matmul_stacked(x.float(), w["q4"], w["s"], w["z"], 0)
    with pytest.raises(TypeError, match="uint8"):
        w4a8.w4a8_matmul_stacked(x, w["q4"].view(torch.int8), w["s"], w["z"], 0)
    with pytest.raises(TypeError, match="bfloat16"):
        w4a8.w4a8_matmul(x, w["q4"][0], w["s"][0], w["z"][0], torch.zeros(256, device="cuda"))
    with pytest.raises(ValueError, match="bad shapes"):
        w4a8.w4a8_matmul_stacked(x, w["q4"], w["s"], w["z"], 2)
    with pytest.raises(ValueError, match="bad shapes"):
        w4a8.w4a8_matmul_stacked(_rn(gen, 4, 384), w["q4"], w["s"], w["z"], 0)
    assert sum(LAUNCHES.values()) == 0


# Since K3 and K8 were redesigned for Hopper (K3 on K7's one-launch body,
# K8 on tensor cores with its merge inside the launch) and K7/K11 take any
# number of kv heads.


def _kv40_pool(gen, Hkv, n, order):
    """row_head of one layer's n pool rows after a 64-row offset: head-major
    runs of random length, or the same ids shuffled."""
    rh = torch.randint(0, Hkv, (n,), generator=gen, dtype=torch.int32).sort().values
    if order == "shuffled":
        rh = rh[torch.randperm(n, generator=gen)]
    return rh


@pytest.mark.parametrize("kind", ["pool", "flat"])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("T", [1, 3])
def test_int4_decode_40_kv_heads(gen, kind, q8, G, T):
    """K7 and K11, exact and q8, with 40 kv heads (five llama3.1-8b
    sequences merged) at G 1, 2 and 4 and one tail length a kv head (0 and
    Tcap - T among them): at G 1 and 2 a row group spans more than 32 kv
    heads. The reference without the segment's first 64 rows must fail."""
    from kvzip_tpu_torch.ops import flat_decode, int4_decode

    Hkv, Tcap, n, off = 40, 48, 3000, 64
    H = Hkv * G
    q = _rn(gen, T, H, D)
    tails = torch.tensor([(7 * h) % (Tcap - T + 1) for h in range(Hkv)], dtype=torch.int32)
    tails[3], tails[5] = 0, Tcap - T
    tails = tails.cuda()
    rh = torch.full((off + n,), -1, dtype=torch.int32)
    rh[off:] = _kv40_pool(gen, Hkv, n, "shuffled" if G == 2 else "head-major")
    kv = (*_quant(gen, off + n), *_quant(gen, off + n))
    kv = (kv[0], kv[1].float(), kv[2].float(), kv[3], kv[4].float(), kv[5].float())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mtc, groups, S = int4_decode.plan(H * T, 1, n, sms)
    assert groups * S <= sms or S == 1
    name = ("pool_decode_attend_int4" if kind == "pool" else "flat_decode_attend_int4") + \
        ("_q8" if q8 else "")
    if kind == "pool":
        kt, vt = _rn(gen, 1, Hkv, Tcap, D), _rn(gen, 1, Hkv, Tcap, D)
        geo = (torch.tensor([off], dtype=torch.int32, device="cuda"),
               torch.tensor([n], dtype=torch.int32, device="cuda"))
        got = pool_decode.pool_decode_attend_int4(q, *kv, rh.cuda(), *geo, kt, vt, tails, 0,
                                                  scale=D ** -0.5, max_rows=n, q8=q8)

        def plain(r):
            out = pool_decode.pool_decode_attend_int4_plain(
                q.float(), *kv, r.cuda(), *geo, kt.float(), vt.float(), tails, 0,
                scale=D ** -0.5, q8=q8, with_slack=q8)
            return out if q8 else (out, None)
    else:
        kt, vt = _rn(gen, Hkv, Tcap, D), _rn(gen, Hkv, Tcap, D)
        kv = tuple(a[None] for a in kv)
        got = flat_decode.flat_decode_attend_int4(q, *kv, rh[None].cuda(), kt, vt, tails,
                                                  scale=D ** -0.5, q8=q8, layer=0)

        def plain(r):
            out = flat_decode.flat_decode_attend_int4_plain(
                q.float(), *kv, r[None].cuda(), kt.float(), vt.float(), tails,
                scale=D ** -0.5, q8=q8, layer=0, with_slack=q8)
            return out if q8 else (out, None)
    want, slack = plain(rh)
    assert _ok(got, want, slack=slack)
    rh_drop = rh.clone()
    rh_drop[off:off + 64] = -1
    drop, slack = plain(rh_drop)
    assert not parity(got, drop, OUT_RTOL, slack)["ok"]
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4), (32, 8), (160, 40)])
@pytest.mark.parametrize("T", [1, 4, 16, 24])
@pytest.mark.parametrize("tails", ["scalar", "per_head"])
@pytest.mark.parametrize("order", ["head-major", "shuffled"])
def test_pool_decode_one_launch(gen, H, Hkv, T, tails, order):
    """K3, one launch: a layer of 2,000 rows after an offset of 64 (no
    multiple of its 32-row items: the last is partial), head-major or
    shuffled, one tail length or one a kv head (one of them 0); the
    reference without the layer's first 64 rows must fail."""
    L, Tcap, n, off = 2, 64, 2000, 64
    P = off + n + 64
    rh = torch.full((P,), -1, dtype=torch.int32)
    rh[off:off + n] = _kv40_pool(gen, Hkv, n, order)
    q, kp, vp = _rn(gen, T, H, D), _rn(gen, P, D), _rn(gen, P, D)
    kt, vt = _rn(gen, L, Hkv, Tcap, D), _rn(gen, L, Hkv, Tcap, D)
    geo = (torch.tensor([0, off], dtype=torch.int32, device="cuda"),
           torch.tensor([0, n], dtype=torch.int32, device="cuda"))
    if tails == "scalar":
        tl = 29
    else:
        tl = torch.tensor([(11 * h + 5) % (Tcap - T + 1) for h in range(Hkv)], dtype=torch.int32)
        tl[Hkv // 2] = 0
        tl = tl.cuda()

    def plain(r):
        return pool_decode.pool_decode_attend_plain(q.float(), kp.float(), vp.float(), r.cuda(),
                                                    *geo, kt.float(), vt.float(), tl, 1,
                                                    scale=D ** -0.5)

    got = pool_decode.pool_decode_attend(q, kp, vp, rh.cuda(), *geo, kt, vt, tl, 1,
                                         scale=D ** -0.5, max_rows=n)
    assert _ok(got, plain(rh))
    rh_drop = rh.clone()
    rh_drop[off:off + 64] = -1
    assert not parity(got, plain(rh_drop), OUT_RTOL)["ok"]
    assert LAUNCHES["pool_decode_attend"] == 1 and sum(LAUNCHES.values()) == 1


def _graph_replay(run):
    """run() eagerly, then captured in a CUDA graph and replayed: the eager
    output and the replay's."""
    eager = run().clone()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    g.replay()
    torch.cuda.synchronize()
    return eager, out


def test_pool_decode_repeat_and_graph(gen):
    """K3: two calls give the same bits, and a CUDA-graph replay (with a
    tail vector) equals the eager call."""
    H, Hkv, T, Tcap, n = 28, 4, 1, 64, 5000
    rh = _kv40_pool(gen, Hkv, n, "head-major").cuda()
    kp, vp = _rn(gen, n, D), _rn(gen, n, D)
    kt, vt = _rn(gen, 1, Hkv, Tcap, D), _rn(gen, 1, Hkv, Tcap, D)
    geo = (torch.zeros(1, dtype=torch.int32, device="cuda"),
           torch.full((1,), n, dtype=torch.int32, device="cuda"))
    tl = torch.tensor([0, 9, Tcap - T, 23], dtype=torch.int32, device="cuda")
    q = _rn(gen, T, H, D)

    def run():
        return pool_decode.pool_decode_attend(q, kp, vp, rh, *geo, kt, vt, tl, 0,
                                              scale=D ** -0.5, max_rows=n)

    first, second = run(), run()
    assert torch.equal(first, second)
    eager, replay = _graph_replay(run)
    assert torch.equal(eager, replay)
    assert _ok(replay, pool_decode.pool_decode_attend_plain(
        q.float(), kp.float(), vp.float(), rh, *geo, kt.float(), vt.float(), tl, 0,
        scale=D ** -0.5))


def _v2_stack(gen, L, IN, OUT):
    """A v2 stack with random bytes and per-(group, column) scales whose
    zeros centre each group's nibbles (weights of standard deviation
    ~0.02), on the card."""
    half, G = OUT // 2, IN // 128
    Gp8 = -(-G // 8) * 8
    q4 = torch.randint(0, 256, (L, IN, half), dtype=torch.uint8, generator=gen)
    s = 0.0043 * (0.75 + 0.5 * torch.rand(L, 2, Gp8, half, generator=gen))
    z = -7.5 * s
    s2, z2 = s.clone(), z.clone()
    s2[:, 0] = s[:, 0] / 16.0
    z2[:, 0] = z[:, 0] + 8.0 * s[:, 0]
    s2[:, :, G:] = z2[:, :, G:] = 0
    return dict(q4=q4.cuda(), s2=s2.to(torch.bfloat16).cuda(), z2=z2.to(torch.bfloat16).cuda())


# qwen2.5-7b's four v2 linears, the int4 lm_head, and OUT/2 = 1,168 (no
# multiple of the kernel's 128-column block)
K8_SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (3584, 152064),
             (384, 2336)]


@pytest.mark.parametrize("IN,OUT", K8_SHAPES)
@pytest.mark.parametrize("T", [1, 3, 4, 16, 24, 100, 256, 511])
def test_w4a8_v2_flagship_shapes(gen, IN, OUT, T):
    """K8 at the flagship's shapes: one launch at T <= 4, two above; the
    reference with one 128-row input group of x zeroed must fail."""
    from kvzip_tpu_torch.ops import w4a8_v2

    w = _v2_stack(gen, 1, IN, OUT)
    x = _rn(gen, T, IN)
    got = w4a8_v2.w4a8_matmul_stacked_v2(x, w["q4"], w["s2"], w["z2"], 0)
    w0 = {k: t[0] for k, t in w.items()}
    assert _ok(got, w4a8_v2.w4a8_jnp_v2(x.float(), w0))
    xd = x.float().clone()
    xd[:, 128:256] = 0
    assert not parity(got, w4a8_v2.w4a8_jnp_v2(xd, w0), OUT_RTOL)["ok"]
    assert LAUNCHES["w4a8_matmul_stacked_v2"] == 1 and sum(LAUNCHES.values()) == 1


@pytest.mark.parametrize("T", [1, 24])
def test_w4a8_v2_repeat_and_graph(gen, T):
    """K8: two calls give the same bits, and a CUDA-graph replay equals the
    eager call."""
    from kvzip_tpu_torch.ops import w4a8_v2

    w = _v2_stack(gen, 2, 3584, 4608)
    x = _rn(gen, T, 3584)

    def run():
        return w4a8_v2.w4a8_matmul_stacked_v2(x, w["q4"], w["s2"], w["z2"], 1)

    first, second = run(), run()
    assert torch.equal(first, second)
    eager, replay = _graph_replay(run)
    assert torch.equal(eager, replay)
    assert _ok(replay, w4a8_v2.w4a8_jnp_v2(x.float(), {k: t[1] for k, t in w.items()}))


# K2 at the scoring chunk's shapes (T 2,304 repeat queries, a 2,048-row
# window) at qwen2.5-7b's G 7 / Hkv 4 and llama3.1-8b's G 4 / Hkv 8; the
# q_valid values are no multiple of the planned block (64 queries at
# 2,060), ctx_len 2,000 and 1,000 stop short of the window, sink 160 and 37
# (odd: no tile starts on a multiple of 8), and q_valid = T. The references
# with 16 fewer valid queries and with the last window tile's columns
# dropped must fail.
@pytest.mark.parametrize("H,Hkv", [(28, 4), (32, 8)])
@pytest.mark.parametrize("sink,ctx_len,q_valid", [(160, 2000, 2060), (37, 1000, 1777),
                                                  (37, 2048, 2304)])
def test_score_kernel_scoring_shapes(gen, H, Hkv, sink, ctx_len, q_valid):
    T, s_ctx = 2304, 2048
    q, keys = _rn(gen, T, H, D), _rn(gen, Hkv, sink + s_ctx + T, D)
    kw = dict(sink=sink, s_ctx=s_ctx, scale=D ** -0.5, model_dtype=torch.bfloat16)
    got = score_kernel.fused_scores(q, keys, ctx_len, q_valid, **kw)
    want = score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len, q_valid, **kw)
    assert _ok(got, want, SCORE_RTOL) and LAUNCHES["fused_scores"] == 1
    assert torch.all(got[:, ctx_len:] == 0)
    fewer = score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len, q_valid - 16,
                                            **kw)
    assert not parity(got, fewer, SCORE_RTOL)["ok"]
    last = want.clone()
    last[:, (ctx_len - 1) // 128 * 128:ctx_len] = 0
    assert not parity(got, last, SCORE_RTOL)["ok"]


def test_score_kernel_repeat_and_graph(gen):
    """K2: two calls give the same bits (atomicMax is independent of
    order), and a CUDA-graph replay equals the eager call."""
    H, Hkv, T, s_ctx, sink, ctx_len, q_valid = 28, 4, 2304, 2048, 160, 2000, 2060
    q, keys = _rn(gen, T, H, D), _rn(gen, Hkv, sink + s_ctx + T, D)
    kw = dict(sink=sink, s_ctx=s_ctx, scale=D ** -0.5, model_dtype=torch.bfloat16)

    def run():
        return score_kernel.fused_scores(q, keys, ctx_len, q_valid, **kw)

    first, second = run(), run()
    assert torch.equal(first, second)
    eager, replay = _graph_replay(run)
    assert torch.equal(eager, replay) and torch.equal(first, replay)


# K5's decode form on one launch: T 1, 4, 9 and 16 at G 7 and G 4; the kv
# heads' bases differ, head 1's live rows end within 16 rows of C (no
# multiple of 8), and the live lengths cross split edges (16,545 rows over
# the planned splits, and a head whose split holds a single row). A
# reference without the first 64 keys must fail.
@pytest.mark.parametrize("H,Hkv", [(28, 4), (32, 8)])
@pytest.mark.parametrize("T", [1, 4, 9, 16])
def test_flash_int4_decode_one_launch(gen, H, Hkv, T):
    from kvzip_tpu_torch.ops import flash_int4

    C = 19456
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S, _ = ragged_decode.plan_splits(C, Hkv, (H // Hkv) * T, sms)
    lens = [16544, C - T - 11] + [9000 - 1237 * i for i in range(2, Hkv)]
    lens[2] = _single_row_live(S, 100) - T
    q = _rn(gen, T, H, D)
    kv = (*_quant(gen, Hkv, C), *_quant(gen, Hkv, C))
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = flash_int4.flash_attend_int4(q, *kv, lens, scale=D ** -0.5)
    want = flash_int4.flash_attend_int4_plain(q.float(), *kv, lens, scale=D ** -0.5)
    assert _ok(got, want)
    assert LAUNCHES["flash_attend_int4"] == LAUNCHES["flash_attend_int4_decode"] == 1
    drop = flash_int4.flash_attend_int4_plain(q.float(), *_int4_drop_first(kv),
                                              (lens - 64).clamp_min(0), scale=D ** -0.5)
    assert not parity(got, drop, OUT_RTOL)["ok"]


def test_flash_int4_decode_graph(gen):
    """K5's decode form: two calls give the same bits, and a CUDA-graph
    replay equals the eager call. Three kv heads of C = 4,099 rows: the
    scale arrays hold an odd count, and the last head reads its last row."""
    from kvzip_tpu_torch.ops import flash_int4

    H, Hkv, T, C = 21, 3, 4, 4099
    q = _rn(gen, T, H, D)
    kv = (*_quant(gen, Hkv, C), *_quant(gen, Hkv, C))
    lens = torch.tensor([4000, 17, C - T], dtype=torch.int32, device="cuda")

    def run():
        return flash_int4.flash_attend_int4(q, *kv, lens, scale=D ** -0.5)

    first, second = run(), run()
    assert torch.equal(first, second)
    eager, replay = _graph_replay(run)
    assert torch.equal(eager, replay)
    assert _ok(replay, flash_int4.flash_attend_int4_plain(q.float(), *kv, lens,
                                                          scale=D ** -0.5))


def _flat_live_stack(gen, L, n_seq, Hkv, R_seg):
    """A padding-heavy flat stack: layer 0 holds no live row, layer 1 every
    row of each segment, the others 1,000 + 37 sb rows (kv head runs of
    random lengths, so head boundaries fall inside 32-row tiles), each
    segment's live rows first. -> row_head (L, n_seq R_seg) and the live
    rows a segment (L, n_seq), on the card."""
    rh = torch.full((L, n_seq * R_seg), -1, dtype=torch.int32)
    live = torch.zeros((L, n_seq), dtype=torch.int32)
    for l in range(1, L):
        for sb in range(n_seq):
            n = R_seg if l == 1 else 1000 + 37 * sb
            cuts = torch.randint(0, n + 1, (Hkv - 1,), generator=gen).sort().values
            counts = torch.diff(torch.cat([torch.tensor([0]), cuts, torch.tensor([n])]))
            rh[l, sb * R_seg:sb * R_seg + n] = torch.repeat_interleave(
                torch.arange(Hkv, dtype=torch.int32) + sb * Hkv, counts)
            live[l, sb] = n
    return rh.cuda(), live.cuda()


def _flat_case(gen, kind, n_seq, T, L=3, R_seg=2048, H=28, Hkv=4, Tcap=64):
    """(run(row_head, layer, seg_rows), plain(row_head, layer) -> (out,
    slack), launch key, row_head, live rows) of K10, K11 or K11-q8 on a
    ``_flat_live_stack``; n_seq 2 takes a tail vector with a 0 in it."""
    from kvzip_tpu_torch.ops import flat_decode

    rh, live = _flat_live_stack(gen, L, n_seq, Hkv, R_seg)
    q = _rn(gen, T, n_seq * H, D)
    kt, vt = _rn(gen, n_seq * Hkv, Tcap, D), _rn(gen, n_seq * Hkv, Tcap, D)
    tl = (torch.tensor([0, 9, Tcap - T, 23] * n_seq, dtype=torch.int32, device="cuda")
          if n_seq > 1 else 7)
    kw = dict(scale=D ** -0.5, n_seq=n_seq)
    if kind == "bf16":
        k, v = _rn(gen, L, n_seq * R_seg, D), _rn(gen, L, n_seq * R_seg, D)

        def run(r, layer, seg):
            return flat_decode.flat_decode_attend(q, k, v, r, kt, vt, tl, layer=layer,
                                                  seg_rows=seg, **kw)

        def plain(r, layer):
            return flat_decode.flat_decode_attend_plain(
                q.float(), k.float(), v.float(), r, kt.float(), vt.float(), tl, layer=layer,
                **kw), None
        return run, plain, "flat_decode_attend", rh, live
    q8 = kind == "int4_q8"
    kq, ks, kz = _quant(gen, L, n_seq * R_seg)
    vq, vs, vz = _quant(gen, L, n_seq * R_seg)
    flat = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())

    def run(r, layer, seg):
        return flat_decode.flat_decode_attend_int4(q, *flat, r, kt, vt, tl, q8=q8, layer=layer,
                                                   seg_rows=seg, **kw)

    def plain(r, layer):
        out = flat_decode.flat_decode_attend_int4_plain(
            q.float(), *flat, r, kt.float(), vt.float(), tl, q8=q8, layer=layer,
            with_slack=q8, **kw)
        return out if q8 else (out, None)
    return run, plain, ("flat_decode_attend_int4_q8" if q8 else "flat_decode_attend_int4"), \
        rh, live


# K10, K11 and K11-q8 given each segment's live rows (seg_rows) on a
# padding-heavy stack (a layer with no live row, one with every row live),
# n_seq 1 (one tail length) and 2 (a tail vector with a 0), T 1, 4, 24 and
# 25. The reference with one 32-row tile of layer 2 dropped must fail.
@pytest.mark.parametrize("kind", ["bf16", "int4", "int4_q8"])
@pytest.mark.parametrize("n_seq", [1, 2])
@pytest.mark.parametrize("T", [1, 4, 24, 25])
def test_flat_decode_live_rows(gen, kind, n_seq, T):
    run, plain, name, rh, live = _flat_case(gen, kind, n_seq, T)
    for layer in range(rh.shape[0]):
        got = run(rh, layer, live)
        want, slack = plain(rh, layer)
        assert _ok(got, want, slack=slack)
    rh_drop = rh.clone()
    rh_drop[2, 64:96] = -1
    drop, slack = plain(rh_drop, 2)
    assert not parity(got, drop, OUT_RTOL, slack)["ok"]
    assert LAUNCHES[name] == rh.shape[0] and sum(LAUNCHES.values()) == rh.shape[0]


# The kernels read no row past seg_rows: given a count 45 rows short of
# layer 2's live rows, they equal the reference without those rows (and
# not the reference with them).
@pytest.mark.parametrize("kind", ["bf16", "int4", "int4_q8"])
@pytest.mark.parametrize("n_seq", [1, 2])
def test_flat_decode_stops_at_seg_rows(gen, kind, n_seq):
    run, plain, name, rh, live = _flat_case(gen, kind, n_seq, 1)
    short = live.clone()
    short[2] -= 45
    got = run(rh, 2, short)
    rh_cut = rh.clone()
    R_seg = rh.shape[1] // n_seq
    for sb in range(n_seq):
        n = int(live[2, sb])
        rh_cut[2, sb * R_seg + n - 45:sb * R_seg + n] = -1
    want, slack = plain(rh_cut, 2)
    assert _ok(got, want, slack=slack)
    full, slack = plain(rh, 2)
    assert not parity(got, full, OUT_RTOL, slack)["ok"]
    assert LAUNCHES[name] == 1


@pytest.mark.parametrize("kind", ["bf16", "int4"])
def test_flat_decode_repeat_and_graph(gen, kind):
    """K10 (and K11 on the same branch) with seg_rows and a tail vector:
    repeated calls give the same bits (each launch leaves its tickets at
    zero for the next), and a CUDA-graph replay equals the eager call."""
    run_, plain, name, rh, live = _flat_case(gen, kind, 2, 4)

    def run():
        return run_(rh, 2, live)

    first, second, third = run(), run(), run()
    assert torch.equal(first, second) and torch.equal(first, third)
    eager, replay = _graph_replay(run)
    assert torch.equal(eager, replay) and torch.equal(first, replay)
    assert _ok(replay, plain(rh, 2)[0])


def test_flat_decode_rejects_bad_seg_rows(gen):
    """seg_rows of another shape, dtype or device raises before a launch."""
    run, _, _, rh, live = _flat_case(gen, "bf16", 1, 1)
    for bad in (live[0], live.long(), live.cpu(), live.repeat(1, 2)):
        with pytest.raises(ValueError, match="seg_rows"):
            run(rh, 0, bad)
    assert sum(LAUNCHES.values()) == 0


# K14 in both forms (ops/fused_act.py::plan): clusters of 16 CTAs at T 1-3,
# of 8 at T 16 and 17, of 4 at T 64, one CTA a row staged in shared memory
# at T 2,304 and 4,097, at llama3.1-8b's F 14,336, qwen2.5-7b's 11,008, the
# narrowest row (8: the row form at every T) and the widest (32,768), for
# both activations; the reference with row 0's scale doubled must fail
# (``_hold_quant``).
@pytest.mark.parametrize("act", ["silu", "gelu_pytorch_tanh"])
@pytest.mark.parametrize("F", [14336, 11008, 8, 32768])
@pytest.mark.parametrize("T", [1, 2, 3, 16, 17, 64, 2304, 4097])
def test_silu_mul_quant_forms(gen, act, T, F):
    from kvzip_tpu_torch.ops import fused_act

    g = torch.Generator(device="cuda").manual_seed(T * 100003 + F)
    gate = (torch.randn(T, F, generator=g, device="cuda") * 3).to(torch.bfloat16)
    up = torch.randn(T, F, generator=g, device="cuda").to(torch.bfloat16)
    got = fused_act.silu_mul_quant(gate, up, act=act)
    assert _hold_quant(got, fused_act.silu_mul_quant_plain(gate, up, act=act))
    assert LAUNCHES["silu_mul_quant"] == 1


@pytest.mark.parametrize("T", [1, 24, 2304])
def test_silu_mul_quant_repeat_and_graph(gen, T):
    """K14: repeated calls give the same bits, and a CUDA-graph replay
    equals the eager call (cluster form at T 1 and 24, row form at 2,304)."""
    from kvzip_tpu_torch.ops import fused_act

    gate, up = _rn(gen, T, 14336) * 3, _rn(gen, T, 14336)

    def run():
        return torch.cat([t.float().reshape(T, -1) for t in fused_act.silu_mul_quant(gate, up)],
                         dim=1)

    first, second = run(), run()
    assert torch.equal(first, second)
    eager, replay = _graph_replay(run)
    assert torch.equal(eager, replay)


def test_silu_mul_quant_rejects_misaligned_rows(gen):
    from kvzip_tpu_torch.ops import fused_act

    buf = _rn(gen, 2 * 1024 + 1)
    gate = buf[1:].view(2, 1024)
    with pytest.raises(ValueError, match="16-byte"):
        fused_act.silu_mul_quant(gate, gate)
    assert sum(LAUNCHES.values()) == 0


# K13 (its grid sized to the card, rows every grid-th, ``plan_norm``) at T
# 1-4,097: one row a CTA up to the grid's size, several rounds above (T
# 2,304 and 4,097 at D 4,096), at llama3.1-8b's D 4,096, 5,120, the
# narrowest row (8: one warp) and the widest (32,768: four vectors a
# thread), with and without gemma's 1 + w; the reference with row 0's scale
# doubled must fail (``_hold_quant``).
@pytest.mark.parametrize("gemma", [False, True])
@pytest.mark.parametrize("W", [4096, 5120, 8, 32768])
@pytest.mark.parametrize("T", [1, 2, 3, 16, 17, 2304, 4097])
def test_rmsnorm_quant_grid(gen, gemma, T, W):
    from kvzip_tpu_torch.ops import fused_act

    g = torch.Generator(device="cuda").manual_seed(T * 100003 + W)
    x = (torch.randn(T, W, generator=g, device="cuda") * 3).to(torch.bfloat16)
    w = (1 + 0.2 * torch.randn(W, generator=g, device="cuda")).to(torch.bfloat16)
    got = fused_act.rmsnorm_quant(x, w, 1e-5, gemma=gemma)
    assert _hold_quant(got, fused_act.rmsnorm_quant_plain(x, w, 1e-5, gemma=gemma))
    assert LAUNCHES["rmsnorm_quant"] == 1


@pytest.mark.parametrize("T", [1, 2304])
def test_rmsnorm_quant_repeat_and_graph(gen, T):
    """K13: repeated calls give the same bits, and a CUDA-graph replay (its
    programmatic dependent launches back to back) equals the eager call."""
    from kvzip_tpu_torch.ops import fused_act

    x = _rn(gen, T, 4096) * 3
    w = (1 + 0.2 * torch.randn(4096, generator=gen)).to("cuda", torch.bfloat16)

    def run():
        return torch.cat([t.float().reshape(T, -1)
                          for t in fused_act.rmsnorm_quant(x, w, 1e-5)], dim=1)

    first, second = run(), run()
    assert torch.equal(first, second)
    eager, replay = _graph_replay(run)
    assert torch.equal(eager, replay)


# The captured decode loop (``engine.DecodeStep``: one step a CUDA graph,
# replayed; the host reads the answer every DECODE_CHUNK steps) against the
# per-token loop (``generate_ids_per_token``) on the same state, on a small
# model the kernels take (head_dim 128, G 4): the greedy tokens, the
# counters after an ``update_cache`` turn and ``LAUNCHES`` equal, with no
# early stop and with an eos the answer emits inside a chunk.
LOOP_KINDS = {"bf16": {}, "quant": dict(kv_quant="int4", weight_quant="w4a8",
                                       embed_quant="int8"),
              "fused": dict(kv_quant="int4", weight_quant="w4a8", embed_quant="int8"),
              "w8a8": dict(kv_quant="int4", weight_quant="w8a8", act_fused="pallas"),
              "flat": dict(flat_decode="legacy")}


def _loop_engine(kind, device="cuda", dtype=torch.bfloat16, **options):
    """The small model, its weights from a seed at 7x the init scale (at 1x
    the greedy answer repeats one token)."""
    from kvzip_tpu_torch.config import tiny_config
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.models.params import init_params
    from kvzip_tpu_torch.tokenizer import ByteTokenizer

    cfg = tiny_config("llama", vocab_size=2048, hidden_size=1024, intermediate_size=2048,
                      num_layers=2, num_heads=8, num_kv_heads=2, head_dim=128)
    params = init_params(cfg, torch.Generator(device).manual_seed(1), device, dtype)
    params["layers"] = {k: v * 7 if k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
                        else v for k, v in params["layers"].items()}
    eng = Engine("tiny-llama", config=cfg, params=params, tokenizer=ByteTokenizer(2048),
                 dtype=dtype, device=device, max_new_tokens=20, decode_budget=160,
                 score_chunk_size=256,
                 **{"capacity_granularity": 256, **LOOP_KINDS[kind], **options})
    eng.fuse_layer = "on" if kind == "fused" else "off"
    eng.eos_ids = (-1,)
    return eng


def _loop_state(eng, seed, ratio=0.3):
    import numpy as np

    rng = np.random.default_rng(seed)
    st = eng.prefill(rng.integers(0, 2048, 700).astype(np.int32), prefill_chunk_size=512)
    eng.prune(st, ratio, "pair")
    return st, rng.integers(0, 2048, 24).astype(np.int32)


def _counters(cache):
    """The counters, and a hybrid cache's stamped ring positions and a sum
    of its ring rows."""
    rings = ((cache.ring_pos.tolist(), float(cache.k_ring.float().sum()))
             if hasattr(cache, "ring_pos") else None)
    return (int(cache.seen), cache.lengths.tolist(), int(getattr(cache, "tail_len", 0)), rings)


def _both_loops(eng, st, q):
    """(tokens, LAUNCHES, counters) of an update_cache turn through each
    loop, the state put back after each."""
    from kvzip_tpu_torch.cache import restore, snapshot
    from kvzip_tpu_torch.engine import Engine, generate_ids_per_token

    snap, ids = snapshot(st.cache), st.prefill_ids
    out = []
    for fn in (Engine.generate_ids, generate_ids_per_token):
        reset_launches()
        toks = fn(eng, q, st, update_cache=True).tolist()
        out.append((toks, dict(LAUNCHES), _counters(st.cache)))
        restore(st.cache, snap)
        st.prefill_ids = ids
        st.snapshot()
    return out


@pytest.mark.parametrize("kind", list(LOOP_KINDS))
def test_captured_loop_matches_per_token_loop(gen, kind):
    eng = _loop_engine(kind)
    st, q = _loop_state(eng, 5)
    (t1, l1, c1), (t2, l2, c2) = _both_loops(eng, st, q)
    assert t1 == t2 and len(t1) == eng.max_new_tokens and l1 == l2 and c1 == c2
    assert len(st._steps) == 1 and next(iter(st._steps.values())).graph is not None
    eos = next(t for i, t in enumerate(t1) if 2 <= i < 8 and t not in t1[:i])
    eng.eos_ids = (eos,)
    (t1, l1, c1), (t2, l2, c2) = _both_loops(eng, st, q)
    assert t1 == t2 and len(t1) < 8 and l1 == l2 and c1 == c2


def test_captured_loop_alternates_two_states(gen):
    from kvzip_tpu_torch.engine import generate_ids_per_token

    eng = _loop_engine("bf16")
    (st1, q1), (st2, q2) = _loop_state(eng, 5), _loop_state(eng, 6)
    want = {1: generate_ids_per_token(eng, q1, st1).tolist(),
            2: generate_ids_per_token(eng, q2, st2).tolist()}
    steps = {}
    for _ in range(2):
        for i, st, q in ((1, st1, q1), (2, st2, q2)):
            assert eng.generate_ids(q, st).tolist() == want[i]
            step = eng.decode_step(st)
            assert steps.setdefault(i, step) is step  # captured once a state
    assert steps[1] is not steps[2]


@pytest.mark.parametrize("impl", ["dense", "blockwise"])
def test_retain_decode_captured_step_matches_eager(gen, impl):
    """A pruned retain state decodes through the masked route (no kernel):
    its captured step gives the per-token loop's tokens, counters and
    (zero) launches, at two ratios of one prefill (a prune drops the
    step)."""
    eng = _loop_engine("bf16", kv_type="retain", attn_impl=impl)
    st, q = _loop_state(eng, 5)
    for ratio in (0.3, 0.6):
        eng.prune(st, ratio, "pair")
        assert eng._impl(st) == impl and not st._steps
        (t1, l1, c1), (t2, l2, c2) = _both_loops(eng, st, q)
        assert t1 == t2 and len(t1) == eng.max_new_tokens and c1 == c2
        assert l1 == l2 and not any(l1.values())
        assert next(iter(st._steps.values())).graph is not None


@pytest.mark.parametrize("kind", ["bf16", "quant"])
def test_dense_cache_any_capacity_runs_kernels(gen, kind):
    """A dense head_dim-128 cache whose capacity is no multiple of 128
    (capacity_granularity 100; none below 3,200 is), prefilled and
    compacted, runs the kernels' route: K1 / K5 at T 64 and K4 / K5's
    decode form at T 4, each within a tenth of the largest probability of
    the masked route's on the same state (bf16 against its float32: 1-5%
    on the card), and a captured decode step equal to the per-token
    loop."""
    import numpy as np

    eng = _loop_engine(kind, flat_decode="off", capacity_granularity=100)
    reset_launches()
    st, q = _loop_state(eng, 5)
    assert type(st.cache).__name__ in ("KVCache", "Int4KVCache")
    assert st.cache.capacity % 128 and eng._impl(st) == "flash"
    big, small = (("flash_attend_int4", "flash_attend_int4_decode") if kind == "quant"
                  else ("flash_attend", "ragged_decode_attend"))
    assert LAUNCHES[big] > 0
    # T 64 and T 4 are one chunk each of the engine's ladder
    for ids, name, other in ((np.resize(q, 64), big, small), (q[:4], small, None)):
        reset_launches()
        got = eng.prob(ids, st)
        assert LAUNCHES[name] == eng.config.num_layers and not LAUNCHES.get(other), \
            (name, dict(LAUNCHES))
        eng.attn_impl = "dense"
        want = eng.prob(ids, st)
        eng.attn_impl = "auto"
        err = float(np.abs(got - want).max())
        assert err < 0.1 * float(want.max()), (name, err, float(want.max()))
    (t1, l1, c1), (t2, l2, c2) = _both_loops(eng, st, q)
    assert t1 == t2 and len(t1) == eng.max_new_tokens and c1 == c2 and l1 == l2
    assert l1[small] > 0


# Batched serving (``serving.MergedBatch``): three pruned states at ratios
# 0.4-0.6 merged into one pool (bf16, int4) or one flat cache (bf16, int4,
# n_seq 3), the queries ingested together, then 12 steps of the merged
# decode step as a CUDA graph; the same step run eagerly from the same
# counters gives the same tokens and the same launch counts.
SERVING_KINDS = {"pool": ("bf16", {}), "int4_pool": ("quant", {}),
                 "flat": ("flat", {}), "int4_flat": ("quant", dict(flat_decode="legacy"))}


@pytest.mark.parametrize("kind", list(SERVING_KINDS))
def test_merged_decode_captured_step_matches_eager(gen, kind):
    from kvzip_tpu_torch import serving
    from kvzip_tpu_torch.cache import restore, snapshot

    loop_kind, options = SERVING_KINDS[kind]
    eng = _loop_engine(loop_kind, **options)
    states, queries = zip(*(_loop_state(eng, 5 + i, r) for i, r in enumerate((0.4, 0.5, 0.6))))
    batch = serving.MergedBatch(eng, states)
    batch.check_room(24 + 12)
    first = batch.ingest(queries)
    snap = snapshot(batch.cache)
    reset_launches()
    toks, n = batch.decode(first, 12, stop_on_eos=False)
    captured = dict(LAUNCHES)
    step = batch.step
    assert step.graph is not None and n == 12 and toks.shape == (3, 13)
    attn = ("flat_decode_attend" if "flat" in kind else "pool_decode_attend") + (
        "_int4" if "int4" in kind else "")
    assert captured[attn] == 12 * eng.config.num_layers
    restore(batch.cache, snap)
    reset_launches()
    step.start(first, 12, stop_on_eos=False)
    for _ in range(12):
        step.step()
    assert int(step.i) == 12 and dict(LAUNCHES) == captured
    assert (step.tokens[:13].T.cpu().numpy() == toks).all()


# K16 at the prefill and scoring shapes of the gemma3 hybrid's v1 route
# (gemma3-4b's gate and down projections): the scoring pass's 2,304 rows,
# the engine ladder's largest chunk (4,096) and a 16,384-row chunk.
@pytest.mark.parametrize("T", [2304, 4096, 16384])
@pytest.mark.parametrize("IN,OUT", [(2560, 10240), (10240, 2560)])
def test_w4a8_v1_kernel_prefill_rows(gen, T, IN, OUT):
    from kvzip_tpu_torch.ops import w4a8

    w = {k: t[0] for k, t in _v1_stack(gen, 1, IN, OUT).items()}
    x = _rn(gen, T, IN)
    got = w4a8.w4a8_matmul(x, w["q4"], w["s"], w["z"])
    assert _ok(got, w4a8._w4a8_jnp(x.float(), w))
    assert LAUNCHES["w4a8_matmul"] == 1


def _ring_state(gen, Hkv, W, Dh, seen0):
    """A full ring of one layer (k, v, stamped positions seen0 - W ..
    seen0 - 1 at their slots p mod W) and the 0-dim ``seen``."""
    pos = torch.arange(seen0 - W, seen0, dtype=torch.int32)
    rp = torch.empty(W, dtype=torch.int32)
    rp[pos % W] = pos
    return dict(k=_rn(gen, Hkv, W, Dh), v=_rn(gen, Hkv, W, Dh), pos=rp.cuda(),
                seen=torch.tensor(seen0, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("T", [1, 4])
def test_attend_ring_captured_after_a_wrap(gen, T):
    """``attend_ring`` then ``ring_append`` (the hybrid's sliding layer),
    captured in a CUDA graph and replayed over steps that wrap the ring's
    end (gemma3-4b's kv heads, head_dim and 1,024-row ring): every
    replay's output and the ring after it equal the eager run's."""
    from kvzip_tpu_torch.cache import ring_append
    from kvzip_tpu_torch.ops.attention import attend_ring

    Hkv, G, Dh, W = 4, 2, 256, 1024
    steps = 3
    seen0 = 4 * W - T - 1  # the steps write across slot W - 1 -> 0
    base = _ring_state(gen, Hkv, W, Dh, seen0)
    ins = [(_rn(gen, T, Hkv * G, Dh), _rn(gen, T, Hkv, Dh), _rn(gen, T, Hkv, Dh))
           for _ in range(steps)]

    def fresh():
        return {k: t.clone() for k, t in base.items()}

    def step(st, buf):
        buf["out"].copy_(attend_ring(buf["q"], st["k"], st["v"], st["pos"], buf["kn"],
                                     buf["vn"], st["seen"], scale=256 ** -0.5, window=W))
        ring_append(st["k"], st["v"], st["pos"], st["seen"], buf["kn"], buf["vn"])
        st["seen"] += T

    def buffers():
        q, kn, vn = (t.clone() for t in ins[0])
        return dict(q=q, kn=kn, vn=vn, out=torch.empty_like(q))

    eager, st, buf = [], fresh(), buffers()
    for q, kn, vn in ins:
        buf["q"].copy_(q), buf["kn"].copy_(kn), buf["vn"].copy_(vn)
        step(st, buf)
        eager.append(buf["out"].clone())
    warm, gbuf = fresh(), buffers()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(warm, gbuf)
    torch.cuda.current_stream().wait_stream(side)
    gst = fresh()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step(gst, gbuf)
    for (q, kn, vn), want in zip(ins, eager):
        gbuf["q"].copy_(q), gbuf["kn"].copy_(kn), gbuf["vn"].copy_(vn)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(gbuf["out"], want)
    for k in ("k", "v", "pos", "seen"):
        assert torch.equal(gst[k], st[k]), k
    assert int(st["pos"].max()) == seen0 + steps * T - 1
    assert not any(LAUNCHES.values())  # torch ops only: the reference's XLA route


def test_hybrid_decode_captured_step_matches_eager(gen):
    """A small gemma3 config (head_dim 256, a 128-row ring that a 700-token
    prefill wraps), pruned at two ratios: the captured decode step over the
    hybrid cache gives the per-token loop's tokens, counters, rings and
    (zero) launches, with no early stop and with an eos inside a chunk."""
    from kvzip_tpu_torch.config import tiny_config
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.models.params import init_params
    from kvzip_tpu_torch.tokenizer import ByteTokenizer

    cfg = tiny_config("gemma3", vocab_size=2048, hidden_size=1024, intermediate_size=2048,
                      num_layers=4, num_heads=8, num_kv_heads=2, head_dim=256,
                      sliding_window=100, query_scale=256 ** -0.5)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(1), "cuda", torch.bfloat16)
    params["layers"] = {k: v * 7 if k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
                        else v for k, v in params["layers"].items()}
    eng = Engine("tiny-gemma3", config=cfg, params=params, tokenizer=ByteTokenizer(2048),
                 max_new_tokens=20, decode_budget=160, capacity_granularity=256,
                 score_chunk_size=256)
    eng.eos_ids = (-1,)
    st, q = _loop_state(eng, 5)
    assert int(st.cache.ring_pos.min()) >= 0
    for ratio in (0.3, 0.6):
        eng.prune(st, ratio, "pair")
        (t1, l1, c1), (t2, l2, c2) = _both_loops(eng, st, q)
        assert t1 == t2 and len(t1) == eng.max_new_tokens and c1 == c2 and l1 == l2
        assert not any(l1.values())
        assert next(iter(st._steps.values())).graph is not None
    eos = next(t for i, t in enumerate(t1) if 2 <= i < 8 and t not in t1[:i])
    eng.eos_ids = (eos,)
    (t1, l1, c1), (t2, l2, c2) = _both_loops(eng, st, q)
    assert t1 == t2 and len(t1) < 8 and c1 == c2


# Tensor parallelism (``kvzip_tpu_torch/parallel``) runs the kernels on a
# rank's local heads: qwen2.5-7b's 28 query heads over 4 kv heads are 14
# over 2 at tp 2 and 7 over 1 at tp 4 (G 7 either way), new shapes for
# the kernels' plans (``ragged_decode.plan_splits``, ``int4_decode.plan``).
TP_LOCAL = [(14, 2), (7, 1)]
TP_LOCAL_CASES = {
    "flash": lambda g, H, Hkv, T: test_flash_kernel(g, H, Hkv, T, 4096, 1792),
    "score": lambda g, H, Hkv, T: test_score_kernel(g, H, Hkv, 256, 300),
    "ragged_decode": lambda g, H, Hkv, T: test_ragged_decode_kernel(g, H, Hkv, T, "ragged"),
    "pool_decode": lambda g, H, Hkv, T: test_pool_decode_kernel(g, H, Hkv, T),
    "flash_int4": lambda g, H, Hkv, T: test_flash_int4_kernel(g, H, Hkv, T, 4096, 3000),
    "flash_int4_prefill": lambda g, H, Hkv, T: test_flash_int4_prefill_kernel(
        g, H, Hkv, T, 2048, 1748),
    "flash_int4_extra": lambda g, H, Hkv, T: test_flash_int4_extra_kernel(
        g, H, Hkv, T, 2048, 1500),
    "pool_decode_int4": lambda g, H, Hkv, T: test_pool_decode_int4_kernel(g, H, Hkv, T),
    "pool_decode_int4_q8": lambda g, H, Hkv, T: test_pool_decode_int4_q8_kernel(g, H, Hkv, T),
}


@pytest.mark.parametrize("H,Hkv", TP_LOCAL)
@pytest.mark.parametrize("kernel,T", [
    ("flash", 2304), ("flash", 48), ("score", 320), ("ragged_decode", 1),
    ("ragged_decode", 8), ("pool_decode", 1), ("pool_decode", 16), ("flash_int4", 1),
    ("flash_int4", 4), ("flash_int4_prefill", 300), ("flash_int4_extra", 320),
    ("pool_decode_int4", 1), ("pool_decode_int4", 16), ("pool_decode_int4_q8", 1),
    ("pool_decode_int4_q8", 16)])
def test_kernels_at_tp_local_heads(gen, H, Hkv, kernel, T):
    """K1-K7 (K5 in both forms, K7 also in q8 mode) at a TP rank's local
    head counts, each against its plain version as in its own test."""
    TP_LOCAL_CASES[kernel](gen, H, Hkv, T)


def test_nccl_world1_decode_step_captures_the_collectives(gen, tmp_path):
    """An engine on a world-size-1 NCCL mesh: its captured decode step
    (the NCCL all-reduces and the head's all-gather inside the graph)
    gives the per-token loop's tokens, counters and launches, and the
    tokens of the same engine without a mesh; the capture counts 2L + 1
    all-reduces (embedding, wo and w_down a layer) and one all-gather a
    step."""
    import torch.distributed as dist

    from kvzip_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        eng = _loop_engine("bf16", mesh=make_mesh(tp=1))
        st, q = _loop_state(eng, 5)
        (t1, l1, c1), (t2, l2, c2) = _both_loops(eng, st, q)
        assert t1 == t2 and l1 == l2 and c1 == c2
        step = next(iter(st._steps.values()))
        L = eng.config.num_layers
        assert step.graph is not None
        assert step.delta[1] == {"all_reduce model": 2 * L + 1, "all_gather model": 1}
        one = _loop_engine("bf16")
        st1, _ = _loop_state(one, 5)
        assert one.generate_ids(q, st1).tolist() == eng.generate_ids(q, st).tolist()
    finally:
        dist.destroy_process_group()
