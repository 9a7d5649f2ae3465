"""The port's int4 KV path against the JAX package on the CPU: the
quantize-on-append cache, and the plain versions of K5 (``flash_attend_int4``),
K6 (``flash_attend_int4_extra``) and K7 (``pool_decode_attend_int4``)
against the reference's Pallas kernels run in interpret mode, on the same
float32 inputs made with numpy from a seed.

The port stores packed rows row-major (C, D//2); the reference stores them
transposed (D//2, C), so the inputs are transposed for it. Tolerance
atol = rtol = 1e-5 on attention outputs: both sides compute in float32 from
the same integers and scales. The plain versions dequantize first, the
reference kernels fold the quant algebra out of the products
(q.x = s (q.n) + z sum(q)), so only the rounding of those partial sums
differs. The cache append is held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import cache as jcache
from kvzip_tpu.ops import flash_int4 as jflash4
from kvzip_tpu.ops import pool_decode as jpool
from kvzip_tpu_torch import cache
from kvzip_tpu_torch.ops import check_tma_aligned, flash_int4, pool_decode
from kvzip_tpu_torch.ops.quant import quantize_int4

from test_torch_engine import one_torch_thread  # noqa: F401

D = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _quant(rng, *shape):
    """Random rows (..., D) as the int4 cache holds them: packed uint8
    (..., D//2) and float32 scale/zero (...)."""
    x = torch.from_numpy(rng.standard_normal((*shape, D)).astype(np.float32))
    p, s, z = quantize_int4(x, pack="split")
    return p, s[..., 0], z[..., 0]


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy())


def _jt(t: torch.Tensor):
    """(Hkv, C, D//2) -> the reference's transposed (Hkv, D//2, C)."""
    return jnp.asarray(t.transpose(-1, -2).contiguous().numpy())


@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("T,lens", [(16, [24, 17]), (32, [0, 90]),
                                    (1, [40, 33]), (4, [64, 57])])
def test_flash_int4_plain_matches_reference_kernel(G, T, lens):
    rng = np.random.default_rng(G * 100 + T)
    Hkv, C = 2, 128
    q = torch.from_numpy(rng.standard_normal((T, Hkv * G, D)).astype(np.float32))
    kq, ks, kz = _quant(rng, Hkv, C)
    vq, vs, vz = _quant(rng, Hkv, C)
    base = torch.tensor(lens, dtype=torch.int32)
    got = flash_int4.flash_attend_int4(q, kq, ks, kz, vq, vs, vz, base,
                                       scale=D ** -0.5)
    want = jflash4.flash_attend_int4(
        _j(q), _jt(kq), _j(ks), _j(kz), _jt(vq), _j(vs), _j(vz), _j(base),
        jnp.asarray(0, jnp.int32), scale=D ** -0.5, block_q=8, block_k=32,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("T,lens", [(16, [40, 29]), (32, [96, 1])])
def test_flash_int4_extra_plain_matches_reference_kernel(G, T, lens):
    rng = np.random.default_rng(G * 10 + T)
    Hkv, C = 2, 128
    q = torch.from_numpy(rng.standard_normal((T, Hkv * G, D)).astype(np.float32))
    cache_kv = (*_quant(rng, Hkv, C), *_quant(rng, Hkv, C))
    extra = (*_quant(rng, T, Hkv), *_quant(rng, T, Hkv))
    base = torch.tensor(lens, dtype=torch.int32)
    got = flash_int4.flash_attend_int4_extra(q, *cache_kv, base, *extra,
                                             scale=D ** -0.5)
    kq, ks, kz, vq, vs, vz = cache_kv
    xkq, xks, xkz, xvq, xvs, xvz = extra
    want = jflash4.flash_attend_int4_extra(
        _j(q), _jt(kq), _j(ks), _j(kz), _jt(vq), _j(vs), _j(vz), _j(base),
        _j(xkq), _j(xks[..., None]), _j(xkz[..., None]), _j(xvq),
        _j(xvs[..., None]), _j(xvz[..., None]), scale=D ** -0.5,
        block_q=8, block_k=32, block_x=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G", [2, 7])
@pytest.mark.parametrize("T", [1, 4])
def test_pool_int4_plain_matches_reference_kernel(G, T):
    rng = np.random.default_rng(G + T)
    L, Hkv, Tcap, tail_len = 3, 2, 16, 5
    rows, off, P, align = [40, 64, 17], [0, 64, 128], 192, 64
    row_head = torch.full((P,), -1, dtype=torch.int32)
    for o, r in zip(off, rows):
        row_head[o:o + r] = torch.from_numpy(
            np.sort(rng.integers(0, Hkv, size=r)).astype(np.int32))
    kq, ks, kz = _quant(rng, P)
    vq, vs, vz = _quant(rng, P)
    kt = torch.from_numpy(rng.standard_normal((L, Hkv, Tcap, D)).astype(np.float32))
    vt = torch.from_numpy(rng.standard_normal((L, Hkv, Tcap, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((T, Hkv * G, D)).astype(np.float32))
    meta = (row_head, torch.tensor(off, dtype=torch.int32),
            torch.tensor(rows, dtype=torch.int32))
    for layer in range(L):
        got = pool_decode.pool_decode_attend_int4(
            q, kq, ks, kz, vq, vs, vz, *meta, kt, vt, tail_len, layer,
            scale=D ** -0.5, max_rows=64)
        want = jpool.pool_decode_attend_int4(
            _j(q), _jt(kq), _j(ks[None]), _j(kz[None]), _jt(vq), _j(vs[None]),
            _j(vz[None]), _j(row_head[None]), _j(meta[1]), _j(meta[2]), _j(kt),
            _j(vt), jnp.asarray(tail_len, jnp.int32), jnp.asarray(layer, jnp.int32),
            scale=D ** -0.5, align=align, max_rows=64, block=32, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int4_append_matches_reference():
    """Quantize-on-append writes the same bytes and scales at each head's
    length (the reference's nibbles transposed back to rows)."""
    rng = np.random.default_rng(9)
    Hkv, C, T = 2, 64, 5
    lens = torch.tensor([3, 11], dtype=torch.int32)
    k = torch.from_numpy(rng.standard_normal((T, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((T, Hkv, D)).astype(np.float32))
    layer = tuple(torch.zeros((Hkv, C, D // 2), dtype=torch.uint8) for _ in range(2)) \
        + tuple(torch.zeros((Hkv, C)) for _ in range(4))
    kq, ks, kz = quantize_int4(k, pack="split")
    vq, vs, vz = quantize_int4(v, pack="split")
    cache.append_layer_int4(layer, lens,
                            (kq, vq, ks[..., 0], kz[..., 0], vs[..., 0], vz[..., 0]))
    jlayer = (jnp.zeros((Hkv, D // 2, C), jnp.uint8),) * 2 \
        + (jnp.zeros((Hkv, C, 1), jnp.float32),) * 4
    want = jcache.append_layer_int4(jlayer, _j(lens), _j(k), _j(v))
    for i, (got, w) in enumerate(zip(layer, want)):
        w = np.asarray(w)
        w = np.swapaxes(w, 1, 2) if i < 2 else w[..., 0]
        np.testing.assert_array_equal(got.numpy(), w)


def test_tma_alignment_check_names_the_misaligned_operands():
    """K5's prefill form, K6, K9 and K1 load q and the rows through TMA,
    which needs 16-byte aligned starts; the wrappers' check (a plain
    function, run before any launch) names each operand that is not."""
    buf = torch.zeros(4 * 64 + 32, dtype=torch.uint8)
    aligned = buf[16 - buf.data_ptr() % 16:][:4 * 64].view(4, 64)
    off = buf[(16 - buf.data_ptr() % 16) + 8:][:4 * 64].view(4, 64)
    check_tma_aligned("k", k_q=aligned, v_q=aligned)
    with pytest.raises(ValueError, match=r"k: v_q must start on 16-byte"):
        check_tma_aligned("k", k_q=aligned, v_q=off)
    with pytest.raises(ValueError, match=r"k: k_q, v_q must start"):
        check_tma_aligned("k", k_q=off, v_q=off)
