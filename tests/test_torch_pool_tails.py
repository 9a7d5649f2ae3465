"""K3 and K7 (exact and q8) with one tail length per kv head, against the
JAX package's Pallas kernels run in interpret mode on the CPU.

The merged pool of serving passes ``tail_len`` as an ``(Hkv,)`` vector
(``kvzip_tpu/serving.py``); tail row j of head h is then visible to query
i iff ``j < tail_len[h] + i + 1``. The cases give distinct lengths, one of
them 0, at T 1 and 4, on a pool of two layers of which one holds no rows.

Tolerances: exact attention atol = rtol = 1e-5, as ``test_torch_ops.py``
holds K3's plain version (both sides float32 from the same rows). The q8
mode as ``test_torch_flat.py`` holds it: atol 5e-3 with an error RMS
under 1e-3 (a quantized p at a .5 boundary may round one step the other
way), and a reference with the layer's first 64-row tile dropped must fail
that hold. A scalar and a vector of equal entries give identical bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.ops import pool_decode as jpool
from kvzip_tpu_torch.ops import pool_decode
from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_flat import BLOCK, _hold_q8, _j, _jt, _quant, _rows

D = 128
TOL = dict(rtol=1e-5, atol=1e-5)
L, Hkv, G, Tcap = 2, 3, 2, 16
ROWS, OFF, P, MAX_ROWS = [150, 0], [0, 192], 256, 192  # layer 1 holds no rows
TAILS = [5, 0, 9]                                      # one per kv head


def _pool(T):
    rng = np.random.default_rng(60 + T)
    rh = torch.full((P,), -1, dtype=torch.int32)
    rh[:ROWS[0]] = torch.from_numpy(np.sort(rng.integers(0, Hkv, ROWS[0])).astype(np.int32))
    q = _rows(rng, T, Hkv * G)
    k, v = _rows(rng, P), _rows(rng, P)
    kt, vt = _rows(rng, L, Hkv, Tcap), _rows(rng, L, Hkv, Tcap)
    meta = (torch.tensor(OFF, dtype=torch.int32), torch.tensor(ROWS, dtype=torch.int32))
    return q, k, v, rh, meta, kt, vt


def _ref_int4(q, pool, rh, meta, kt, vt, tl, layer, q8):
    return np.asarray(jpool.pool_decode_attend_int4(
        _j(q), _jt(pool[0]), _j(pool[1])[None], _j(pool[2])[None], _jt(pool[3]),
        _j(pool[4])[None], _j(pool[5])[None], _j(rh)[None], *(_j(m) for m in meta),
        _j(kt), _j(vt), jnp.asarray(TAILS, jnp.int32), jnp.int32(layer), scale=D ** -0.5,
        align=64, max_rows=MAX_ROWS, block=BLOCK, interpret=True, q8=q8))


@pytest.mark.parametrize("layer", [0, 1], ids=["rows", "empty"])
@pytest.mark.parametrize("T", [1, 4])
def test_pool_decode_per_head_tails_match_reference_kernel(T, layer):
    q, k, v, rh, meta, kt, vt = _pool(T)
    tl = torch.tensor(TAILS, dtype=torch.int32)
    got = pool_decode.pool_decode_attend(q, k, v, rh, *meta, kt, vt, tl, layer,
                                         scale=D ** -0.5, max_rows=MAX_ROWS)
    want = jpool.pool_decode_attend(
        _j(q), _jt(k), _j(v), _j(rh)[None], *(_j(m) for m in meta), _j(kt), _j(vt),
        jnp.asarray(TAILS, jnp.int32), jnp.int32(layer), scale=D ** -0.5, align=64,
        max_rows=MAX_ROWS, block=BLOCK, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["exact", "q8"])
@pytest.mark.parametrize("layer", [0, 1], ids=["rows", "empty"])
@pytest.mark.parametrize("T", [1, 4])
def test_pool_decode_int4_per_head_tails_match_reference_kernel(T, layer, q8):
    q, k, v, rh, meta, kt, vt = _pool(T)
    pool = (*_quant(k), *_quant(v))
    tl = torch.tensor(TAILS, dtype=torch.int32)
    kw = dict(scale=D ** -0.5, max_rows=MAX_ROWS, q8=q8)
    got = pool_decode.pool_decode_attend_int4(q, *pool, rh, *meta, kt, vt, tl, layer, **kw)
    want = _ref_int4(q, pool, rh, meta, kt, vt, tl, layer, q8)
    if not q8:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    rh_drop = rh.clone()
    rh_drop[OFF[layer]:OFF[layer] + BLOCK] = -1
    if layer == 1:  # no rows to drop: drop the first tail rows instead
        kt = kt.clone()
        kt[layer, :, :4] *= -1
    dropped = pool_decode.pool_decode_attend_int4(q, *pool, rh_drop, *meta, kt, vt, tl, layer,
                                                  **kw)
    _hold_q8(got.numpy(), want, dropped.numpy())


@pytest.mark.parametrize("kind", ["bf16", "int4", "int4_q8"])
def test_scalar_and_equal_vector_tails_give_identical_bits(kind):
    q, k, v, rh, meta, kt, vt = _pool(4)
    vec = torch.full((Hkv,), 6, dtype=torch.int32)
    outs = []
    for tl in (6, vec):
        if kind == "bf16":
            outs.append(pool_decode.pool_decode_attend(q, k, v, rh, *meta, kt, vt, tl, 0,
                                                       scale=D ** -0.5, max_rows=MAX_ROWS))
        else:
            outs.append(pool_decode.pool_decode_attend_int4(
                q, *_quant(k), *_quant(v), rh, *meta, kt, vt, tl, 0, scale=D ** -0.5,
                max_rows=MAX_ROWS, q8=kind == "int4_q8"))
    assert torch.equal(outs[0], outs[1])
