"""The launch plan of K7, K11, K3 and K10 (``kvzip_tpu_torch/ops/int4_decode.py``),
which mirrors the arithmetic of ``csrc/int4_decode.cuh``: the grid fits the
card whenever its CTAs wait for each other, every row of a segment and of
each kv head's visible tail lies in exactly one work item, segment items
start on the 64-row q8 tiles of the segment's row 0, the merge slices
cover the output once, and the schedule (items interleaved over the CTAs,
an online softmax a split, the partials merged) reproduces K7's, K11's,
K3's and K10's plain versions (K10's with its items cut at each segment's
live rows). The schedule is emulated in float64 on dequantized rows,
so the tolerance is float32 rounding of the plain versions: rtol = atol =
1e-5, as ``test_torch_ops.py`` holds K3's plain version.
"""

import pytest
import torch

from kvzip_tpu_torch.ops import flat_decode, int4_decode, pool_decode
from kvzip_tpu_torch.ops.quant import dequantize_int4, quantize_int4
from test_torch_engine import one_torch_thread  # noqa: F401

D = 128
SMS = 132  # the H100's SM count
TOL = dict(rtol=1e-5, atol=1e-5)

# (T, kv heads, G, sequences, largest segment, rows of this segment)
SHAPES = {
    "smoke pool T 1": (1, 4, 7, 1, 21056, 19850),
    "smoke pool T 24": (24, 4, 7, 1, 21056, 17000),
    "smoke flat full": (1, 4, 7, 1, 98304, 98304),
    "flat two sequences T 4": (4, 4, 7, 2, 24576, 24576),
    "llama T 1": (1, 8, 4, 1, 20000, 20000),
    "fewer rows than splits": (1, 4, 7, 1, 21056, 70),
    "empty layer": (1, 4, 2, 1, 384, 0),
    "T 16 small": (16, 4, 1, 1, 384, 300),
}


def _covers(items, seg_rows, lens, T, Tcap):
    seg = [r for kind, *rest in items if kind == "seg" for r in range(rest[0], rest[0] + rest[1])]
    assert seg == list(range(seg_rows))
    assert all(c0 % int4_decode.ROW_TILE == 0 for kind, c0, _ in
               (i for i in items if i[0] == "seg"))
    for h, tl in enumerate(lens):
        rows = [r for kind, *rest in items if kind == "tail" and rest[0] == h
                for r in range(rest[1], rest[1] + rest[2])]
        assert rows == list(range(max(0, min(tl + T, Tcap))))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_fits_and_covers(name):
    T, Hkv, G, n_seq, max_rows, seg_rows = SHAPES[name]
    head_rows = G * T
    rows = Hkv * head_rows
    mtc, groups, S = int4_decode.plan(rows, n_seq, max_rows, SMS)
    assert mtc in (2, 4, 8) and S >= 1
    assert (groups - 1) * 16 * mtc < rows <= groups * 16 * mtc
    assert S == 1 or groups * n_seq * S <= SMS
    for rg in range(groups):
        h0, nh = int4_decode.row_group_heads(rg, mtc, rows, head_rows)
        lens = [40 + 7 * (h0 + h) for h in range(nh)]
        items = int4_decode.work_items(seg_rows, lens, T, 768)
        splits = int4_decode.split_items(len(items), S)
        assert sorted(i for sp in splits for i in sp) == list(range(len(items)))
        _covers([items[i] for i in sorted(i for sp in splits for i in sp)], seg_rows, lens, T,
                 768)
        nrows = min(16 * mtc, rows - rg * 16 * mtc)
        slices = int4_decode.merge_slices(nrows, S)
        units = [u for a, b in slices for u in range(a, b)]
        assert units == list(range(nrows * D // 4))


def _rand_int4(gen, *shape):
    p, s, z = quantize_int4(torch.randn(*shape, D, generator=gen), pack="split")
    return p, s[..., 0].float(), z[..., 0].float()


def _emulate(q, seg_k, seg_v, rh, match, kt, vt, tails, T, G, Hkv, scale, sms,
             row_tile=int4_decode.ROW_TILE, plan_rows=None, n_seq=1):
    """One sequence through the kernel's schedule in float64: every row
    group's items split over S CTAs, each CTA's online softmax over its
    items, the S partials merged. seg_k/seg_v (n, D) dequantized rows with
    kv heads rh (n,) (``match`` added to the sequence's kv head index);
    kt/vt (Hkv, Tcap, D); tails one length a kv head. The launch is planned
    for ``n_seq`` sequences and segments of ``plan_rows`` rows (default n),
    as a flat wrapper plans it from R_seg while the kernel's items stop at
    the segment's n live rows. Returns (G*T*Hkv, D) rows, head-major."""
    rows, Tcap = Hkv * G * T, kt.shape[1]
    mtc, groups, S = int4_decode.plan(rows, n_seq, max(plan_rows or seg_k.shape[0], 1), sms,
                                      row_tile)
    qr = torch.stack([q[r % T, (r // T)] for r in range(rows)]).double()  # (rows, D)
    out = torch.empty(rows, D, dtype=torch.float64)
    for rg in range(groups):
        r0, nrows = rg * 16 * mtc, min(16 * mtc, rows - rg * 16 * mtc)
        h0, nh = int4_decode.row_group_heads(rg, mtc, rows, G * T)
        items = int4_decode.work_items(seg_k.shape[0], tails[h0:h0 + nh], T, Tcap, row_tile)
        row_head = torch.arange(r0, r0 + nrows) // (G * T)
        row_t = torch.arange(r0, r0 + nrows) % T
        parts = []
        for split in int4_decode.split_items(len(items), S):
            m = torch.full((nrows,), -torch.inf, dtype=torch.float64)
            l = torch.zeros(nrows, dtype=torch.float64)
            acc = torch.zeros(nrows, D, dtype=torch.float64)
            for it in (items[i] for i in split):
                if it[0] == "seg":
                    c0, n = it[1], it[2]
                    k, v = seg_k[c0:c0 + n].double(), seg_v[c0:c0 + n].double()
                    ok = rh[c0:c0 + n][None] == (row_head + match)[:, None]
                else:
                    h, c0, n = h0 + it[1], it[2], it[3]
                    k, v = kt[h, c0:c0 + n].double(), vt[h, c0:c0 + n].double()
                    col = torch.arange(c0, c0 + n)
                    ok = (row_head[:, None] == h) & (col[None] < tails[h] + row_t[:, None] + 1)
                s = (qr[r0:r0 + nrows] @ k.T * scale).masked_fill(~ok, -torch.inf)
                mn = torch.maximum(m, s.amax(-1))
                mu = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
                p, alpha = torch.exp(s - mu[:, None]), torch.exp(m - mu)
                l, acc, m = l * alpha + p.sum(-1), acc * alpha[:, None] + p @ v, mn
            parts.append((m, l, acc))
        M = torch.stack([p[0] for p in parts]).amax(0)
        Mu = torch.where(torch.isinf(M), torch.zeros_like(M), M)
        w = [torch.exp(p[0] - Mu) for p in parts]
        L = sum(wi * p[1] for wi, p in zip(w, parts))
        A = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
        out[r0:r0 + nrows] = A / L.clamp_min(1e-37)[:, None]
    return out


def _to_out(rows_out, T, H):
    return rows_out.reshape(H, T, D).transpose(0, 1).float()


@pytest.mark.parametrize("T,Hkv,G,rows,sms", [(1, 4, 7, 700, 132), (1, 4, 7, 700, 3),
                                              (24, 4, 7, 300, 132), (16, 2, 2, 40, 132),
                                              (1, 3, 2, 0, 132)])
def test_schedule_reproduces_k7_plain(T, Hkv, G, rows, sms):
    """An unsorted row_head with one kv head absent from the layer, one
    tail length a kv head (one of them 0)."""
    gen = torch.Generator().manual_seed(T * 100 + rows + sms)
    H, Tcap, P = Hkv * G, 64, 1024
    off = 128
    rh = torch.full((P,), -1, dtype=torch.int32)
    rh[off:off + rows] = torch.randint(0, Hkv - 1, (rows,), generator=gen, dtype=torch.int32)
    kq, ks, kz = _rand_int4(gen, P)
    vq, vs, vz = _rand_int4(gen, P)
    q = torch.randn(T, H, D, generator=gen)
    kt, vt = (torch.randn(1, Hkv, Tcap, D, generator=gen) for _ in range(2))
    tails = [0] + [7 * h + 3 for h in range(1, Hkv)]
    lo, n = torch.tensor([off], dtype=torch.int32), torch.tensor([rows], dtype=torch.int32)
    want = pool_decode.pool_decode_attend_int4_plain(
        q, kq, ks, kz, vq, vs, vz, rh, lo, n, kt, vt, torch.tensor(tails, dtype=torch.int32), 0,
        scale=D ** -0.5)
    seg = [dequantize_int4(p[off:off + rows], s[off:off + rows, None], z[off:off + rows, None],
                           torch.float32, pack="split") for p, s, z in ((kq, ks, kz), (vq, vs, vz))]
    got = _emulate(q, *seg, rh[off:off + rows], 0, kt[0], vt[0], tails, T, G, Hkv, D ** -0.5,
                   sms)
    torch.testing.assert_close(_to_out(got, T, H), want, **TOL)


@pytest.mark.parametrize("T", [1, 4])
def test_schedule_reproduces_k11_plain_two_sequences(T):
    """Sequence 1's rows carry row_head ids Hkv ... 2 Hkv - 1, as the merged
    flat layout stores them, and trailing padding (-1)."""
    gen = torch.Generator().manual_seed(11 + T)
    Hkv, G, R_seg, Tcap, n_seq = 2, 3, 512, 32, 2
    H = Hkv * G
    rh = torch.full((n_seq * R_seg,), -1, dtype=torch.int32)
    for sb, n in enumerate((300, 450)):
        rh[sb * R_seg:sb * R_seg + n] = torch.randint(0, Hkv, (n,), generator=gen,
                                                      dtype=torch.int32).sort().values + sb * Hkv
    kq, ks, kz = _rand_int4(gen, n_seq * R_seg)
    vq, vs, vz = _rand_int4(gen, n_seq * R_seg)
    q = torch.randn(T, n_seq * H, D, generator=gen)
    kt, vt = (torch.randn(n_seq * Hkv, Tcap, D, generator=gen) for _ in range(2))
    tails = torch.tensor([5, 0, 17, 9], dtype=torch.int32)
    want = flat_decode.flat_decode_attend_int4_plain(q, kq, ks, kz, vq, vs, vz, rh, kt, vt,
                                                     tails, scale=D ** -0.5, n_seq=n_seq)
    k, v = (dequantize_int4(p, s[:, None], z[:, None], torch.float32, pack="split")
            for p, s, z in ((kq, ks, kz), (vq, vs, vz)))
    for sb in range(n_seq):
        seg = slice(sb * R_seg, (sb + 1) * R_seg)
        heads = slice(sb * Hkv, (sb + 1) * Hkv)
        got = _emulate(q[:, sb * H:(sb + 1) * H], k[seg], v[seg], rh[seg], sb * Hkv,
                       kt[heads], vt[heads], tails[heads].tolist(), T, G, Hkv, D ** -0.5, SMS)
        torch.testing.assert_close(_to_out(got, T, H), want[:, sb * H:(sb + 1) * H], **TOL)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("T", [1, 3])
def test_plan_takes_40_kv_heads(G, T):
    """40 kv heads (five llama3.1-8b sequences merged): the plan keeps the
    grid within the SM count, no row group spans more kv heads than the
    kernel's per-row-group arrays hold (at G 1 and 2 more than 32), and
    every row of the segment and of each head's tail lies in one item, for
    K7's 64-row and K3's 32-row segment items. With more row groups and
    sequences than SMs, one split: nothing waits."""
    Hkv, seg_rows = 40, 3000
    rows = Hkv * G * T
    for row_tile in (int4_decode.ROW_TILE, int4_decode.BF_TILE):
        mtc, groups, S = int4_decode.plan(rows, 1, seg_rows, SMS, row_tile)
        assert groups * S <= SMS
        spans = [int4_decode.row_group_heads(rg, mtc, rows, G * T)[1] for rg in range(groups)]
        assert max(spans) <= int4_decode.RG_HEADS
        assert max(spans) > 32 or G * T > 3
        for rg in range(groups):
            h0, nh = int4_decode.row_group_heads(rg, mtc, rows, G * T)
            lens = [(7 * (h0 + h)) % 40 for h in range(nh)]
            items = int4_decode.work_items(seg_rows, lens, T, 48, row_tile)
            assert all(i[1] % row_tile == 0 for i in items if i[0] == "seg")
            splits = int4_decode.split_items(len(items), S)
            _covers_rows([items[i] for sp in splits for i in sp], seg_rows, lens, T, 48)
    assert int4_decode.plan(rows, 200, seg_rows, SMS)[2] == 1


def _covers_rows(items, seg_rows, lens, T, Tcap):
    seg = sorted(r for kind, *rest in items if kind == "seg"
                 for r in range(rest[0], rest[0] + rest[1]))
    assert seg == list(range(seg_rows))
    for h, tl in enumerate(lens):
        rows = sorted(r for kind, *rest in items if kind == "tail" and rest[0] == h
                      for r in range(rest[1], rest[1] + rest[2]))
        assert rows == list(range(max(0, min(tl + T, Tcap))))


@pytest.mark.parametrize("T,Hkv,G,rows", [(1, 40, 1, 300), (3, 40, 2, 200), (4, 4, 7, 700),
                                          (24, 2, 2, 100)])
def test_schedule_reproduces_k3_plain(T, Hkv, G, rows):
    """K3's schedule (32-row bf16 items, interleaved over the CTAs, merged)
    against its plain version: a shuffled row_head, one tail length a kv
    head (one of them 0)."""
    gen = torch.Generator().manual_seed(T * 1000 + Hkv + rows)
    H, Tcap, off = Hkv * G, 32, 64
    P = off + rows + 64
    rh = torch.full((P,), -1, dtype=torch.int32)
    rh[off:off + rows] = torch.randint(0, Hkv, (rows,), generator=gen, dtype=torch.int32)
    kp, vp = torch.randn(P, D, generator=gen), torch.randn(P, D, generator=gen)
    q = torch.randn(T, H, D, generator=gen)
    kt, vt = (torch.randn(1, Hkv, Tcap, D, generator=gen) for _ in range(2))
    tails = [0] + [(5 * h + 3) % (Tcap - T + 1) for h in range(1, Hkv)]
    lo, n = torch.tensor([off], dtype=torch.int32), torch.tensor([rows], dtype=torch.int32)
    want = pool_decode.pool_decode_attend_plain(q, kp, vp, rh, lo, n, kt, vt,
                                                torch.tensor(tails, dtype=torch.int32), 0,
                                                scale=D ** -0.5)
    got = _emulate(q, kp[off:off + rows], vp[off:off + rows], rh[off:off + rows], 0, kt[0],
                   vt[0], tails, T, G, Hkv, D ** -0.5, SMS, int4_decode.BF_TILE)
    torch.testing.assert_close(_to_out(got, T, H), want, **TOL)


@pytest.mark.parametrize("n_seq", [1, 2])
@pytest.mark.parametrize("T", [1, 24])
def test_schedule_reproduces_k10_plain(n_seq, T):
    """K10's schedule (K3's: 32-row bf16 items, interleaved, merged) on a
    padded flat stack, planned from R_seg with the items cut at each
    segment's live rows (``cache.live_rows``), against its plain version
    over the whole padded segment: the padding rows (large values, row_head
    -1) change nothing. Sequence 1's rows carry kv head ids Hkv ...; one
    tail length a (sequence, kv head), one of them 0."""
    from kvzip_tpu_torch.cache import live_rows

    gen = torch.Generator().manual_seed(100 + 10 * n_seq + T)
    Hkv, G, R_seg, Tcap = 3, 2, 640, 48
    H = Hkv * G
    rh = torch.full((n_seq * R_seg,), -1, dtype=torch.int32)
    for sb, n in enumerate((301, 517)[:n_seq]):
        rh[sb * R_seg:sb * R_seg + n] = torch.randint(0, Hkv, (n,), generator=gen,
                                                      dtype=torch.int32).sort().values + sb * Hkv
    k, v = torch.randn(n_seq * R_seg, D, generator=gen), torch.randn(n_seq * R_seg, D,
                                                                     generator=gen)
    k[rh < 0], v[rh < 0] = 1e4, -1e4
    q = torch.randn(T, n_seq * H, D, generator=gen)
    kt, vt = (torch.randn(n_seq * Hkv, Tcap, D, generator=gen) for _ in range(2))
    tails = torch.tensor([0, 5, 17, 9, 24, 3][:n_seq * Hkv], dtype=torch.int32)
    want = flat_decode.flat_decode_attend_plain(q, k, v, rh, kt, vt, tails, scale=D ** -0.5,
                                                n_seq=n_seq)
    live = live_rows(rh.view(n_seq, R_seg))[:, 0].tolist()
    for sb in range(n_seq):
        seg = slice(sb * R_seg, sb * R_seg + live[sb])
        heads = slice(sb * Hkv, (sb + 1) * Hkv)
        got = _emulate(q[:, sb * H:(sb + 1) * H], k[seg], v[seg], rh[seg], sb * Hkv, kt[heads],
                       vt[heads], tails[heads].tolist(), T, G, Hkv, D ** -0.5, SMS,
                       int4_decode.BF_TILE, plan_rows=R_seg, n_seq=n_seq)
        torch.testing.assert_close(_to_out(got, T, H), want[:, sb * H:(sb + 1) * H], **TOL)
