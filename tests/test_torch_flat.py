"""The port's flat decode layout against the JAX package on the CPU: the
plain versions of K10 (``flat_decode_attend``), K11 (``flat_decode_attend_int4``,
exact and ``q8``) and K7's ``q8`` mode against the reference's Pallas
kernels run in interpret mode, and the flat builders and the refold
against the reference's, on the same float32 inputs made with numpy from a
seed.

Layouts: the port keeps K row-major ``(L, R_pad, D)`` and packed rows
``(L, R_pad, D//2)``; the reference stores them transposed (``(L, D,
R_pad)``, ``(L, D//2, R_pad)``), so each side is converted explicitly.

Tolerances: exact attention atol = rtol = 2e-5 (both sides float32 from the
same rows; the reference folds the int4 quant algebra out of its products,
the plain version dequantizes first). The q8 mode at one shared p tile of
64 rows: the s8 dots are exact integers and q's quantization is the same
arithmetic on both sides, but the plain version takes one softmax maximum
per row where the reference keeps a running one, so a quantized p that lies
at a .5 boundary may round one step the other way; one step moves an
output by about ps_s * 15 / l, under 5e-3 at these sizes, so q8 is held at
atol = 5e-3 with an error RMS under 1e-3 — and a reference with one 64-row
tile of the flat rows dropped must fail that hold. The builders and the
refold are held bit for bit, except the float32 scales of the tail rows
that a refold quantizes: the reference computes (max - min) / 15 + 1e-8
inside one fused XLA program, which rounds one scale in twenty a last bit
away from PyTorch's two steps, so those are held to one float32 ulp
(rtol 2^-23); their nibbles are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import cache as jcache
from kvzip_tpu.ops import flat_decode as jflat
from kvzip_tpu.ops import pool_decode as jpool
from kvzip_tpu_torch import cache
from kvzip_tpu_torch.ops import flat_decode, pool_decode
from kvzip_tpu_torch.ops.quant import quantize_int4

from test_torch_engine import one_torch_thread  # noqa: F401

D = 128
TOL = dict(rtol=2e-5, atol=2e-5)
Q8_ATOL, Q8_RMS = 5e-3, 1e-3
BLOCK = 64  # the kernels' key tile, the reference's block here


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy())


def _jt(t: torch.Tensor):
    """Row-major (..., R, W) -> the reference's transposed (..., W, R)."""
    return jnp.asarray(t.transpose(-1, -2).contiguous().numpy())


def _rows(rng, *shape):
    return torch.from_numpy(rng.standard_normal((*shape, D)).astype(np.float32))


def _quant(x):
    p, s, z = quantize_int4(x, pack="split")
    return p, s[..., 0], z[..., 0]


def _row_head(rng, L, n_seq, Hkv, R_seg):
    """Per layer and sequence: each kv head's rows head-major from the
    segment's start (global head ids sb * Hkv + h), then padding (-1)."""
    rh = torch.full((L, n_seq * R_seg), -1, dtype=torch.int32)
    for l in range(L):
        for sb in range(n_seq):
            counts = rng.integers(20, R_seg // Hkv, Hkv)
            ids = np.repeat(np.arange(Hkv) + sb * Hkv, counts)
            rh[l, sb * R_seg:sb * R_seg + len(ids)] = torch.from_numpy(ids.astype(np.int32))
    return rh


def _hold_q8(got, want, dropped):
    got, want, dropped = (np.asarray(a, np.float64) for a in (got, want, dropped))
    err = np.abs(got - want)
    rms = np.sqrt((err ** 2).mean())
    assert err.max() <= Q8_ATOL and rms <= Q8_RMS, (err.max(), rms)
    derr = np.abs(got - dropped)
    assert derr.max() > Q8_ATOL or np.sqrt((derr ** 2).mean()) > Q8_RMS


# (n_seq, T, per-head tail_len): one query row per head and a single
# sequence, then a merged batch of two with 4-token queries and one tail
# length per (sequence, kv head)
CASES = [(1, 1, False), (2, 4, True)]


def _flat_case(n_seq, T, per_head):
    rng = np.random.default_rng(10 * n_seq + T)
    L, Hkv, G, R_seg, Tcap, layer = 2, 2, 3, 192, 16, 1
    rh = _row_head(rng, L, n_seq, Hkv, R_seg)
    q = _rows(rng, T, n_seq * Hkv * G)
    k, v = _rows(rng, L, n_seq * R_seg), _rows(rng, L, n_seq * R_seg)
    kt, vt = _rows(rng, n_seq * Hkv, Tcap), _rows(rng, n_seq * Hkv, Tcap)
    if per_head:
        tl = torch.from_numpy(rng.integers(0, Tcap - T, n_seq * Hkv).astype(np.int32))
    else:
        tl = 5
    return q, k, v, rh, kt, vt, tl, layer, n_seq


def _jtl(tl):
    return jnp.asarray(tl.numpy() if isinstance(tl, torch.Tensor) else np.int32(tl))


@pytest.mark.parametrize("n_seq,T,per_head", CASES)
def test_flat_decode_plain_matches_reference_kernel(n_seq, T, per_head):
    q, k, v, rh, kt, vt, tl, layer, n_seq = _flat_case(n_seq, T, per_head)
    got = flat_decode.flat_decode_attend(q, k, v, rh, kt, vt, tl, scale=D ** -0.5,
                                         n_seq=n_seq, layer=layer)
    want = jflat.flat_decode_attend(_j(q), _jt(k), _j(v), _j(rh), _j(kt), _j(vt), _jtl(tl),
                                    scale=D ** -0.5, block=BLOCK, interpret=True,
                                    n_seq=n_seq, layer=jnp.int32(layer))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _int4_case(n_seq, T, per_head):
    q, k, v, rh, kt, vt, tl, layer, n_seq = _flat_case(n_seq, T, per_head)
    flat = (*_quant(k), *_quant(v))                 # kq, ks, kz, vq, vs, vz
    jflat_args = (_jt(flat[0]), _j(flat[1]), _j(flat[2]), _jt(flat[3]), _j(flat[4]),
                  _j(flat[5]))
    return q, flat, jflat_args, rh, kt, vt, tl, layer, n_seq


@pytest.mark.parametrize("q8", [False, True], ids=["exact", "q8"])
@pytest.mark.parametrize("n_seq,T,per_head", CASES)
def test_flat_decode_int4_plain_matches_reference_kernel(n_seq, T, per_head, q8):
    q, flat, jargs, rh, kt, vt, tl, layer, n_seq = _int4_case(n_seq, T, per_head)
    kw = dict(scale=D ** -0.5, n_seq=n_seq, layer=layer)
    got = flat_decode.flat_decode_attend_int4(q, *flat, rh, kt, vt, tl, q8=q8, **kw)
    want = jflat.flat_decode_attend_int4(_j(q), *jargs, _j(rh), _j(kt), _j(vt), _jtl(tl),
                                         scale=D ** -0.5, block=BLOCK, interpret=True,
                                         q8=q8, n_seq=n_seq, layer=jnp.int32(layer))
    if not q8:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    rh_drop = rh.clone()
    rh_drop[layer, :BLOCK] = -1  # the first 64-row tile of the layer dropped
    dropped = flat_decode.flat_decode_attend_int4(q, *flat, rh_drop, kt, vt, tl, q8=True, **kw)
    _hold_q8(got.numpy(), np.asarray(want), dropped.numpy())
    exact = flat_decode.flat_decode_attend_int4(q, *flat, rh, kt, vt, tl, **kw)
    # the q8 price at these sizes, the reference's own bound on it
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("T", [1, 4])
def test_pool_decode_int4_q8_plain_matches_reference_kernel(T):
    rng = np.random.default_rng(40 + T)
    L, Hkv, G, Tcap, tail_len, layer = 2, 2, 3, 16, 6, 1
    rows, off, P = [150, 230], [0, 192], 448
    rh = torch.full((P,), -1, dtype=torch.int32)
    for o, r in zip(off, rows):
        rh[o:o + r] = torch.from_numpy(np.sort(rng.integers(0, Hkv, r)).astype(np.int32))
    q = _rows(rng, T, Hkv * G)
    pool = (*_quant(_rows(rng, P)), *_quant(_rows(rng, P)))
    kt, vt = _rows(rng, L, Hkv, Tcap), _rows(rng, L, Hkv, Tcap)
    meta = (torch.tensor(off, dtype=torch.int32), torch.tensor(rows, dtype=torch.int32))
    got = pool_decode.pool_decode_attend_int4(q, *pool, rh, *meta, kt, vt, tail_len, layer,
                                              scale=D ** -0.5, max_rows=256, q8=True)
    want = jpool.pool_decode_attend_int4(
        _j(q), _jt(pool[0]), _j(pool[1])[None], _j(pool[2])[None], _jt(pool[3]),
        _j(pool[4])[None], _j(pool[5])[None], _j(rh)[None], *(_j(m) for m in meta),
        _j(kt), _j(vt), jnp.int32(tail_len), jnp.int32(layer), scale=D ** -0.5,
        align=64, max_rows=256, block=BLOCK, interpret=True, q8=True)
    rh_drop = rh.clone()
    rh_drop[off[layer]:off[layer] + BLOCK] = -1
    dropped = pool_decode.pool_decode_attend_int4(q, *pool, rh_drop, *meta, kt, vt, tail_len,
                                                  layer, scale=D ** -0.5, max_rows=256, q8=True)
    _hold_q8(got.numpy(), np.asarray(want), dropped.numpy())


# ------------------------------------------------------------- builders
CFG = dict(L=2, H=2, C=256, sink=4, ctx=100)


@pytest.fixture(scope="module")
def dense():
    """A dense float32 cache and a dense int4 cache holding the same rows
    (sink + ctx of them per head), each in both packages' layouts, and a
    keep mask."""
    rng = np.random.default_rng(3)
    L, H, C, n = CFG["L"], CFG["H"], CFG["C"], CFG["sink"] + CFG["ctx"]
    k = np.zeros((L, H, C, D), np.float32)
    v = np.zeros((L, H, C, D), np.float32)
    k[:, :, :n] = rng.standard_normal((L, H, n, D))
    v[:, :, :n] = rng.standard_normal((L, H, n, D))
    lengths = np.full((L, H), n, np.int32)
    tk = cache.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                       lengths=torch.from_numpy(lengths), seen=n)
    jk = jcache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths),
                        seen=jnp.int32(n), valid=jnp.ones((L, H, C), bool))
    (kq, ks, kz), (vq, vs, vz) = _quant(torch.from_numpy(k)), _quant(torch.from_numpy(v))
    t4 = cache.Int4KVCache(k_q=kq, v_q=vq, k_s=ks, k_z=kz, v_s=vs, v_z=vz,
                           lengths=torch.from_numpy(lengths), seen=n)
    j4 = jcache.Int4KVCache(k_q=_jt(kq), v_q=_jt(vq), k_s=_j(ks)[..., None],
                            k_z=_j(kz)[..., None], v_s=_j(vs)[..., None],
                            v_z=_j(vz)[..., None], lengths=jnp.asarray(lengths),
                            seen=jnp.int32(n), valid=jnp.ones((L, H, C), bool))
    keep = rng.random((L, H, CFG["ctx"])) > 0.5
    return tk, jk, t4, j4, keep


def _same_flat(t, j, scale_rtol=0.0):
    """The port's flat cache equals the reference's after the layout
    conversion: rows (and bytes) bit for bit, row_head and lengths; int4
    scales within ``scale_rtol``."""
    if isinstance(t, cache.FlatInt4KV):
        pairs = dict(k_flat_q=np.swapaxes(np.asarray(j.k_flat_q), 1, 2),
                     v_flat_q=np.swapaxes(np.asarray(j.v_flat_q), 1, 2),
                     **{f: np.asarray(getattr(j, f)) for f in ("k_flat_s", "k_flat_z",
                                                               "v_flat_s", "v_flat_z")})
    else:
        pairs = dict(k_flat=np.swapaxes(np.asarray(j.k_flat), 1, 2), v_flat=np.asarray(j.v_flat))
    pairs.update(row_head=np.asarray(j.row_head), lengths=np.asarray(j.lengths),
                 k_tail=np.asarray(j.k_tail))
    for f, want in pairs.items():
        got = getattr(t, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (f, got.shape, want.shape)
        if f.endswith("_s") and scale_rtol:
            np.testing.assert_allclose(got, want, rtol=scale_rtol, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert t.tail_len == int(j.tail_len) and t.seen == int(j.seen)


def test_build_flat_matches_reference(dense):
    tk, jk, _, _, keep = dense
    got = cache.build_flat(tk, torch.from_numpy(keep), CFG["sink"], 192, 8)
    _same_flat(got, jcache.build_flat(jk, jnp.asarray(keep), CFG["sink"], 192, 8))


@pytest.mark.parametrize("stepped", [False, True], ids=["oneshot", "stepped"])
def test_build_flat_int4_matches_reference(dense, stepped):
    _, _, t4, j4, keep = dense
    if stepped:
        t4 = dataclasses.replace(t4)  # the stepped build drops the arrays it consumed
        got = cache.build_flat_int4_stepped(t4, torch.from_numpy(keep), CFG["sink"], 192, 8,
                                            torch.float32)
        assert t4.k_q is None and t4.v_s is None
    else:
        got = cache.build_flat_int4(t4, torch.from_numpy(keep), CFG["sink"], 192, 8,
                                    torch.float32)
    want = jcache.build_flat_int4(j4, jnp.asarray(keep), CFG["sink"], 192, 8, jnp.float32)
    _same_flat(got, want)


@pytest.mark.parametrize("int4", [False, True], ids=["bf16-layout", "int4"])
def test_refold_flat_matches_reference(dense, int4):
    """Two committed turns' rows in the tail (6 rows, different per head),
    folded into a larger r_pad, int4 tail rows quantized like context rows."""
    tk, jk, t4, j4, keep = dense
    if int4:
        t = cache.build_flat_int4(t4, torch.from_numpy(keep), CFG["sink"], 192, 8,
                                  torch.float32)
        j = jcache.build_flat_int4(j4, jnp.asarray(keep), CFG["sink"], 192, 8, jnp.float32)
    else:
        t = cache.build_flat(tk, torch.from_numpy(keep), CFG["sink"], 192, 8)
        j = jcache.build_flat(jk, jnp.asarray(keep), CFG["sink"], 192, 8)
    rng = np.random.default_rng(5)
    tail = rng.standard_normal((2,) + tuple(t.k_tail.shape)).astype(np.float32)
    tail[:, :, :, 6:] = 0
    t = dataclasses.replace(t, k_tail=torch.from_numpy(tail[0]), v_tail=torch.from_numpy(tail[1]),
                            tail_len=6)
    j = dataclasses.replace(j, k_tail=jnp.asarray(tail[0]), v_tail=jnp.asarray(tail[1]),
                            tail_len=jnp.int32(6))
    _same_flat(cache.refold_flat(t, 256), jax.device_get(jcache.refold_flat(j, 256)),
               scale_rtol=2.0 ** -23 if int4 else 0.0)


def _live_rows_first(c):
    """seg_rows is (L, 1) int32, each layer's count of row_head >= 0, and
    those rows are the layer's first (where the kernels stop reading)."""
    live = (c.row_head >= 0).sum(-1, keepdim=True)
    assert c.seg_rows.dtype == torch.int32 and c.seg_rows.shape == (c.row_head.shape[0], 1)
    assert torch.equal(c.seg_rows, live.to(torch.int32))
    assert torch.equal(c.row_head >= 0, torch.arange(c.row_head.shape[1])[None] < live)


@pytest.mark.parametrize("build", ["bf16", "int4", "stepped", "refold", "refold-int4",
                                   "synthetic", "synthetic-int4"])
def test_flat_builds_store_live_rows(dense, build):
    """Every flat build stores each layer's live rows (``seg_rows``)."""
    tk, _, t4, _, keep = dense
    kw = (torch.from_numpy(keep), CFG["sink"], 192, 8)
    if build.startswith("synthetic"):
        c = cache.synthetic_full_flat(CFG["L"], CFG["H"], D, 100, 256, 8, torch.float32, "cpu",
                                      int4=build.endswith("int4"))
        assert torch.equal(c.seg_rows, torch.full((CFG["L"], 1), CFG["H"] * 100,
                                                  dtype=torch.int32))
    elif build == "stepped":
        c = cache.build_flat_int4_stepped(dataclasses.replace(t4), *kw, torch.float32)
    elif build in ("int4", "refold-int4"):
        c = cache.build_flat_int4(t4, *kw, torch.float32)
    else:
        c = cache.build_flat(tk, *kw)
    if build.startswith("refold"):
        _live_rows_first(c)
        c = dataclasses.replace(c, k_tail=torch.randn(c.k_tail.shape),
                                v_tail=torch.randn(c.v_tail.shape), tail_len=6)
        c = cache.refold_flat(c, 256)
    _live_rows_first(c)
