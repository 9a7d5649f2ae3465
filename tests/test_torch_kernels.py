"""On the card: each CUDA kernel (K1-K4) against its plain version, on the
same bf16 inputs, the plain version computed in float32.

Run on a machine with a card: ``python -m pytest -n 0 -m cuda
tests/test_torch_kernels.py``. Here (no card) every test skips.
Tolerance: ``kvzip_tpu_torch.ops.parity``, relative to the reference's
size: elementwise |got - want| <= rtol |want| + 0.02 RMS(want), with rtol
2^-7 on attention outputs (bf16 probabilities in the p.v product, bf16
output) and 2^-4 on scores (bf16-rounded logits), and RMS(got - want) <=
2^-7 RMS(want).
"""

import pytest
import torch

from kvzip_tpu_torch.ops import (LAUNCHES, OUT_RTOL, SCORE_RTOL, flash, parity,
                                 pool_decode, ragged_decode, reset_launches,
                                 score_kernel)

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


def _ok(got, want, rtol=OUT_RTOL):
    r = parity(got, want, rtol)
    assert r["ok"], r
    return True


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("T,C,base", [(48, 256, 100), (256, 1024, 0),
                                      (1024, 8192, 5000)])
def test_flash_kernel(gen, H, Hkv, T, C, base):
    q, k, v = _rn(gen, T, H, D), _rn(gen, Hkv, C, D), _rn(gen, Hkv, C, D)
    lens = torch.tensor([max(base - 7 * i, 0) for i in range(Hkv)],
                        dtype=torch.int32, device="cuda")
    got = flash.flash_attend(q, k, v, lens, scale=D ** -0.5)
    want = flash.flash_attend_plain(q.float(), k.float(), v.float(), lens,
                                    scale=D ** -0.5)
    assert _ok(got, want) and LAUNCHES["flash_attend"] == 1


@pytest.mark.parametrize("H,Hkv", [(4, 2), (28, 4)])
@pytest.mark.parametrize("T", [1, 3, 8])
def test_ragged_decode_kernel(gen, H, Hkv, T):
    C = 4096
    q, k, v = _rn(gen, T, H, D), _rn(gen, Hkv, C, D), _rn(gen, Hkv, C, D)
    lens = torch.tensor([3000 - 400 * i for i in range(Hkv)],
                        dtype=torch.int32, device="cuda")
    got = ragged_decode.ragged_decode_attend(q, k, v, lens, scale=D ** -0.5)
    want = ragged_decode.ragged_decode_attend_plain(
        q.float(), k.float(), v.float(), lens, scale=D ** -0.5)
    assert _ok(got, want) and LAUNCHES["ragged_decode_attend"] == 1


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
