#!/usr/bin/env python3
"""Device-time breakdown of the port's Hopper attention kernels at the
shapes of ``chip_smoke.py``'s main paths: K1 (``flash_attend``) and K4
(``ragged_decode_attend``) on the bf16 path, K5's prefill form
(``flash_attend_int4``, 4,096 queries after 12,288 rows) and K6
(``flash_attend_int4_extra``, a 2,304-query scoring chunk after 16,544 rows)
on the int4 path (qwen2.5-7b: 28 heads over 4 kv heads, head_dim 128; a
16,544-row prefill in a 19,456-row cache), and K9 (``windowed_attend``) at
llama3.1-8b's windowed pass (32 heads over 8, 2,304 queries, a 2,048-row
window, ctx_len 2,000 and 384, a 40-row sink); K7 and K11
(``pool_decode_attend_int4``, ``flat_decode_attend_int4``) in their exact
and q8 modes at ``chip_smoke.py``'s decode shapes: a ~30% int4 pool of 28
layers (5,000-10,000 rows a kv head, tail 40 of 768) at T = 1 and 24, the
evicted flat stack at T = 1 and 24, and the full flat stack (98,304 rows a
layer) at T = 1; K3 (``pool_decode_attend``) on the same ~30% pool
geometry with bf16 rows at T = 1, 4, 16 and 24, cycling over the 28
layers; K2 (``fused_scores``) at the scoring chunk (2,304 repeat
queries, a 2,048-row window, ctx_len 2,000, q_valid 2,060, a 160-row sink)
of qwen2.5-7b and of llama3.1-8b (32 heads over 8); K5's decode form
(``flash_attend_int4`` at T 1, 4 and 16) on 28 layers' dense int4 caches
after the prefill, cycled; K10 (``flat_decode_attend``) on bf16 flat
stacks of 28 layers, evicted (~30% of each kv head's rows, every layer
padded to the largest) and full (98,304 rows a layer), at T 1 and 24 and
n_seq 1 and 2 (two sequences merged, one tail length per (sequence, kv
head)), cycled. K10 and K11 get the stacks' live rows a segment
(``seg_rows``) where the checkout's wrappers take it.

    python3 tools/attn_profile.py [--root DIR] [--out FILE]
        [--only k4,k1,k5,k9,k7,k11,k3,k2,k5d,k10]

``--root`` imports ``kvzip_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so two versions can be
timed in one run on one card. For each shape it prints one JSON line:
the wrapper's device time from a CUDA-graph replay (``graph_ms``, as the
smoke takes it), SDPA's time on the same inputs, and the device time of
each CUDA kernel the wrapper launches, from ``torch.profiler`` over eager
calls (``kernels``: name -> mean us per wrapper call). K4 cycles through
28 layers' caches so every call reads its rows from device memory. Beside
K1 and K4 stands SDPA (with the mask), beside K9 SDPA with its bool mask,
and beside K5 and K6 the yardstick of the same attention computed by
dequantizing the live rows to bf16 and calling K1 (``deq_k1_ms``, and
``k1_ms`` for K1 alone on the dequantized rows); beside K7 the layer's
rows dequantized to bf16 and K3 (``deq_k3_ms``, ``k3_ms``), beside K11 at
one sequence the same with K10 (``deq_k10_ms``, ``k10_ms``). K7 and K11
cycle over the 28 layers, so each call reads its rows from device memory
(the stacks exceed the 50 MB L2). Needs a card.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

L, H, HKV, D = 28, 28, 4, 128
PREFILL, CAPACITY = 16544, 19456
SEED_ROWS = 2   # the rows a kv head keeps in the K7/K11 stacks


def graph_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_us(fn, calls):
    """Mean device microseconds per wrapper call of each CUDA kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            out[e.key[:80]] = t / calls
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="k4,k1,k5,k9,k7,k11,k3,k2,k5d,k10",
                    help="comma-separated sections to run")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from kvzip_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    logs = _build.build_all(("flash", "ragged_decode", "flash_int4", "windowed_attend",
                             "pool_decode", "pool_decode_int4", "flat_decode",
                             "flat_decode_int4", "score"))
    rows = [dict(card=card, root=os.path.abspath(args.root), torch=torch.__version__,
                 cuda=torch.version.cuda,
                 ptxas=[ln.strip() for lg in logs.values() for ln in lg.splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling" in ln])]
    print(json.dumps(rows[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = D ** -0.5

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def sdpa(q, k, v, mask=None):
        return F.scaled_dot_product_attention(q.transpose(0, 1)[None], k[None], v[None],
                                              attn_mask=mask, enable_gqa=True)

    def emit(r):
        rows.append(r)
        print(json.dumps(r), flush=True)

    if "k3" in only:
        k3_rows(emit, rn, scale)
    if "k10" in only:
        k10_rows(emit, rn, scale)
    if "k7" in only or "k11" in only:
        int4_decode_rows(emit, rn, scale, only)
    if "k4" in only:
        k4_rows(emit, rn, sdpa, scale)
    if "k1" in only:
        k1_rows(emit, rn, sdpa, scale)
    if "k5" in only:
        k5_rows(emit, rn, scale)
    if "k9" in only:
        k9_rows(emit, rn, sdpa, scale)
    if "k2" in only:
        k2_rows(emit, rn, scale)
    if "k5d" in only:
        k5d_rows(emit, rn, scale)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


def pool_geometry(gen):
    """The ~30% pool of ``chip_smoke.py``: per layer and kv head 20-40% of
    the prefill's rows, head-major, layers aligned as the port's pool
    aligns them -> (row_head on the card, (layer_off, layer_rows) on the
    card, rows a layer, allocated rows, max rows)."""
    import numpy as np
    import torch

    from kvzip_tpu_torch.pool import POOL_ALIGN, plan_offsets

    rows_h = torch.randint(int(0.2 * PREFILL), int(0.4 * PREFILL), (L, HKV), generator=gen)
    per_layer = rows_h.sum(1).numpy()
    off, alloc, max_rows = plan_offsets(per_layer, POOL_ALIGN)
    rh = torch.full((alloc,), -1, dtype=torch.int32)
    for l in range(L):
        rh[int(off[l]):int(off[l]) + int(per_layer[l])] = torch.repeat_interleave(
            torch.arange(HKV, dtype=torch.int32), rows_h[l])
    geo = (torch.from_numpy(off).cuda(), torch.from_numpy(per_layer.astype(np.int32)).cuda())
    return rh.cuda(), geo, per_layer, alloc, max_rows


def k3_rows(emit, rn, scale):
    """K3 on a ~30% bf16 pool of 28 layers (tail 40 of 768), cycled."""
    import torch

    from kvzip_tpu_torch.ops import pool_decode

    rh, geo, per_layer, alloc, max_rows = pool_geometry(torch.Generator().manual_seed(SEED_ROWS))
    kp, vp = rn(alloc, D), rn(alloc, D)
    kt, vt = rn(L, HKV, 768, D), rn(L, HKV, 768, D)
    for T in (1, 4, 16, 24):
        q = rn(T, H, D)
        cyc = iter(range(10 ** 9))

        def k3():
            return pool_decode.pool_decode_attend(q, kp, vp, rh, *geo, kt, vt, 40, next(cyc) % L,
                                                  scale=scale, max_rows=max_rows)

        emit(dict(kernel="pool_decode_attend", T=T, live_rows=float(per_layer.mean()),
                  ms=graph_ms(k3, 56), kernels=kernel_us(k3, 56)))
    del kp, vp, kt, vt
    torch.cuda.empty_cache()


def seg_kw(fn, seg_rows):
    """``seg_rows=`` for a wrapper that takes it (a parent checkout's may
    not)."""
    return {"seg_rows": seg_rows} if "seg_rows" in inspect.signature(fn).parameters else {}


def flat_stack(gen, n_seq, full):
    """row_head (L, n_seq * r_pad) of a flat stack (each (layer, sequence)
    segment's kv heads head-major from its start, then padding), r_pad, the
    live rows a segment (L, n_seq) int32, all on the card."""
    import torch

    from kvzip_tpu_torch.engine import _round_flat_rows

    if full:
        rows_h = torch.full((L, n_seq, HKV), PREFILL, dtype=torch.int64)
    else:
        rows_h = torch.randint(int(0.2 * PREFILL), int(0.4 * PREFILL), (L, n_seq, HKV),
                               generator=gen)
    live = rows_h.sum(-1)
    r_pad = _round_flat_rows(int(live.max()))
    rh = torch.full((L, n_seq * r_pad), -1, dtype=torch.int32)
    for l in range(L):
        for sb in range(n_seq):
            rh[l, sb * r_pad:sb * r_pad + int(live[l, sb])] = torch.repeat_interleave(
                torch.arange(HKV, dtype=torch.int32) + sb * HKV, rows_h[l, sb])
    return rh.cuda(), r_pad, live.to(torch.int32).cuda()


def k10_rows(emit, rn, scale):
    """K10 on bf16 flat stacks: evicted and full, n_seq 1 and 2, T 1 and
    24, 28 layers cycled."""
    import torch

    from kvzip_tpu_torch.ops import flat_decode

    gen = torch.Generator().manual_seed(SEED_ROWS)
    tcap = 768
    for full in (False, True):
        for n_seq in (1, 2):
            rh, r_pad, live = flat_stack(gen, n_seq, full)
            k, v = rn(L, n_seq * r_pad, D), rn(L, n_seq * r_pad, D)
            kt, vt = rn(n_seq * HKV, tcap, D), rn(n_seq * HKV, tcap, D)
            tl = 40 if n_seq == 1 else torch.randint(
                0, tcap - 64, (n_seq * HKV,), generator=gen, dtype=torch.int32).cuda()
            kw = seg_kw(flat_decode.flat_decode_attend, live)
            for T in (1, 24):
                q = rn(T, n_seq * H, D)
                cyc = iter(range(10 ** 9))

                def k10():
                    return flat_decode.flat_decode_attend(q, k, v, rh, kt, vt, tl, scale=scale,
                                                          n_seq=n_seq, layer=next(cyc) % L,
                                                          **kw)

                emit(dict(kernel="flat_decode_attend", T=T, n_seq=n_seq,
                          layout="full" if full else "evicted", r_pad=r_pad,
                          live_rows=float(live.float().mean()), seg_rows=bool(kw),
                          ms=graph_ms(k10, 56), kernels=kernel_us(k10, 56)))
            del k, v, kt, vt, rh
            torch.cuda.empty_cache()


def int4_decode_rows(emit, rn, scale, only):
    """K7 on a ~30% int4 pool and K11 on flat stacks, exact and q8, each
    beside dequantize-then-K3 (K7) or -K10 (K11 at one sequence)."""
    import numpy as np
    import torch

    from kvzip_tpu_torch.engine import _round_flat_rows
    from kvzip_tpu_torch.ops import flat_decode, pool_decode
    from kvzip_tpu_torch.pool import POOL_ALIGN, plan_offsets

    gen = torch.Generator().manual_seed(SEED_ROWS)
    tail_len, tcap = 40, 768
    f32 = torch.float32
    if "k7" in only:
        rows_h = torch.randint(int(0.2 * PREFILL), int(0.4 * PREFILL), (L, HKV), generator=gen)
        per_layer = rows_h.sum(1).numpy()
        off, alloc, max_rows = plan_offsets(per_layer, POOL_ALIGN)
        rh = torch.full((alloc,), -1, dtype=torch.int32)
        for l in range(L):
            rh[int(off[l]):int(off[l]) + int(per_layer[l])] = torch.repeat_interleave(
                torch.arange(HKV, dtype=torch.int32), rows_h[l])
        rh = rh.cuda()
        pool = (*quant(rn, alloc, dtype=f32), *quant(rn, alloc, dtype=f32))
        kt, vt = rn(L, HKV, tcap, D), rn(L, HKV, tcap, D)
        geo = (torch.from_numpy(off).cuda(), torch.from_numpy(per_layer.astype(np.int32)).cuda())
        zero_off = torch.zeros(L, dtype=torch.int32, device="cuda")
        for T in (1, 24):
            q = rn(T, H, D)
            for q8 in (False, True):
                cyc = iter(range(10 ** 9))

                def k7():
                    return pool_decode.pool_decode_attend_int4(
                        q, *pool, rh, *geo, kt, vt, tail_len, next(cyc) % L, scale=scale,
                        max_rows=max_rows, q8=q8)

                r = dict(kernel="pool_decode_attend_int4" + ("_q8" if q8 else ""), T=T,
                         live_rows=float(per_layer.mean()), ms=graph_ms(k7, 56),
                         kernels=kernel_us(k7, 56))
                if not q8:
                    def layer_rows(l):
                        o, n = int(off[l]), int(per_layer[l])
                        return (deq(*(a[o:o + n] for a in pool[:3])),
                                deq(*(a[o:o + n] for a in pool[3:])), rh[o:o + n], l)

                    def k3(rows):
                        kd, vd, rhl, l = rows
                        return pool_decode.pool_decode_attend(
                            q, kd, vd, rhl, zero_off, geo[1], kt, vt, tail_len, l,
                            scale=scale, max_rows=max_rows)

                    fixed = [layer_rows(l) for l in range(L)]
                    r["deq_k3_ms"] = graph_ms(lambda: k3(layer_rows(next(cyc) % L)), 28)
                    r["k3_ms"] = graph_ms(lambda: k3(fixed[next(cyc) % L]), 56)
                    del fixed
                emit(r)
        del pool, kt, vt, rh
    if "k11" not in only:
        return
    for full in (False, True):
        if full:
            rows_h = torch.full((L, HKV), PREFILL, dtype=torch.int64)
        else:
            rows_h = torch.randint(int(0.2 * PREFILL), int(0.4 * PREFILL), (L, HKV),
                                   generator=gen)
        live = rows_h.sum(-1)
        r_pad = _round_flat_rows(int(live.max()))
        rh = torch.full((L, r_pad), -1, dtype=torch.int32)
        for l in range(L):
            rh[l, :int(live[l])] = torch.repeat_interleave(torch.arange(HKV, dtype=torch.int32),
                                                           rows_h[l])
        rh = rh.cuda()
        flat = (*quant(rn, L, r_pad, dtype=f32), *quant(rn, L, r_pad, dtype=f32))
        kt, vt = rn(HKV, tcap, D), rn(HKV, tcap, D)
        kw = seg_kw(flat_decode.flat_decode_attend_int4, live[:, None].to(torch.int32).cuda())
        for T in ((1,) if full else (1, 24)):
            q = rn(T, H, D)
            for q8 in (False, True):
                cyc = iter(range(10 ** 9))

                def k11():
                    return flat_decode.flat_decode_attend_int4(
                        q, *flat, rh, kt, vt, tail_len, scale=scale, q8=q8,
                        layer=next(cyc) % L, **kw)

                r = dict(kernel="flat_decode_attend_int4" + ("_q8" if q8 else ""), T=T,
                         layout="full" if full else "evicted", r_pad=r_pad, seg_rows=bool(kw),
                         live_rows=float(live.float().mean()), ms=graph_ms(k11, 56),
                         kernels=kernel_us(k11, 56))
                if not q8:
                    def layer_rows(l):
                        n = int(live[l])
                        return (deq(*(a[l, :n] for a in flat[:3])),
                                deq(*(a[l, :n] for a in flat[3:])), rh[l, :n])

                    def k10(rows):
                        kd, vd, rhl = rows
                        return flat_decode.flat_decode_attend(q, kd, vd, rhl, kt, vt, tail_len,
                                                              scale=scale)

                    fixed = [layer_rows(l) for l in range(L)]
                    r["deq_k10_ms"] = graph_ms(lambda: k10(layer_rows(next(cyc) % L)), 28)
                    r["k10_ms"] = graph_ms(lambda: k10(fixed[next(cyc) % L]), 56)
                    del fixed
                emit(r)
        del flat, rh
        torch.cuda.empty_cache()


def k4_rows(emit, rn, sdpa, scale):
    import torch

    from kvzip_tpu_torch.ops import ragged_decode

    # K4: T new rows after the prefill, 28 layers cycled
    kc, vc = rn(L, HKV, CAPACITY, D), rn(L, HKV, CAPACITY, D)
    lens = torch.full((HKV,), PREFILL, dtype=torch.int32, device="cuda")
    for T in (1, 8):
        q = rn(T, H, D)
        S = PREFILL + T
        mask = torch.arange(S, device="cuda")[None] < PREFILL + torch.arange(T, device="cuda")[:, None] + 1
        cyc = iter(range(10 ** 9))

        def k4():
            l = next(cyc) % L
            return ragged_decode.ragged_decode_attend(q, kc[l], vc[l], lens, scale=scale)

        def lib():
            l = next(cyc) % L
            return sdpa(q, kc[l, :, :S], vc[l, :, :S], None if T == 1 else mask)

        emit(dict(kernel="ragged_decode_attend", T=T, live=S, ms=graph_ms(k4, 56),
                  sdpa_ms=graph_ms(lib, 56), kernels=kernel_us(k4, 56)))


def k1_rows(emit, rn, sdpa, scale):
    import torch

    from kvzip_tpu_torch.ops import flash

    # K1: the prefill's largest chunk and a scoring window
    k, v = rn(HKV, CAPACITY, D), rn(HKV, CAPACITY, D)
    for T, base in ((4096, 12288), (2304, PREFILL)):
        q = rn(T, H, D)
        lens = torch.full((HKV,), base, dtype=torch.int32, device="cuda")
        S = base + T
        ke, ve = k[:, :S].contiguous(), v[:, :S].contiguous()
        mask = torch.arange(S, device="cuda")[None] < base + torch.arange(T, device="cuda")[:, None] + 1

        def k1():
            return flash.flash_attend(q, k, v, lens, scale=scale)

        emit(dict(kernel="flash_attend", T=T, base=base, ms=graph_ms(k1, 10),
                  sdpa_ms=graph_ms(lambda: sdpa(q, ke, ve, mask), 10),
                  kernels=kernel_us(k1, 5)))
        del ke, ve, mask


def quant(rn, *shape, dtype=None):
    """Random N(0, 1) rows (..., D) as the int4 caches hold them: packed
    (..., D//2) uint8, scale and zero (...) (bf16, or ``dtype``)."""
    from kvzip_tpu_torch.ops.quant import quantize_int4

    p, s_, z = quantize_int4(rn(*shape, D), pack="split")
    s_, z = s_[..., 0], z[..., 0]
    return (p, s_, z) if dtype is None else (p, s_.to(dtype), z.to(dtype))


def deq(p, s_, z):
    import torch

    from kvzip_tpu_torch.ops.quant import dequantize_int4

    return dequantize_int4(p, s_[..., None], z[..., None], torch.bfloat16, pack="split")


def k5_rows(emit, rn, scale):
    import torch

    from kvzip_tpu_torch.ops import flash, flash_int4

    kv = (*quant(rn, HKV, CAPACITY), *quant(rn, HKV, CAPACITY))
    for T, base in ((4096, 12288), (2304, PREFILL)):
        q = rn(T, H, D)
        lens = torch.full((HKV,), base, dtype=torch.int32, device="cuda")
        if T == 4096:
            name, S = "flash_attend_int4", base + T

            def kern():
                return flash_int4.flash_attend_int4(q, *kv, lens, scale=scale)

            def live_rows():
                return (deq(*(a[:, :S] for a in kv[:3])), deq(*(a[:, :S] for a in kv[3:])))
        else:
            name, extra = "flash_attend_int4_extra", (*quant(rn, T, HKV), *quant(rn, T, HKV))

            def kern():
                return flash_int4.flash_attend_int4_extra(q, *kv, lens, *extra, scale=scale)

            def live_rows():
                return tuple(torch.cat([deq(*(a[:, :base] for a in kv[i:i + 3])),
                                        deq(*extra[i:i + 3]).transpose(0, 1)], dim=1)
                             for i in (0, 3))
        kd, vd = live_rows()
        r = dict(kernel=name, T=T, base=base, ms=graph_ms(kern, 10),
                 deq_k1_ms=graph_ms(lambda: flash.flash_attend(q, *live_rows(), lens, scale=scale), 10),
                 k1_ms=graph_ms(lambda: flash.flash_attend(q, kd, vd, lens, scale=scale), 10),
                 kernels=kernel_us(kern, 5))
        del kd, vd
        emit(r)


def k9_rows(emit, rn, sdpa, scale):
    import torch

    from kvzip_tpu_torch.ops import windowed_attend

    # K9 at llama3.1-8b's windowed pass
    Hw, Hkvw, T, s_ctx, sink = 32, 8, 2304, 2048, 40
    s0, K = sink + s_ctx, sink + s_ctx + T
    q, keys, vals = rn(T, Hw, D), rn(Hkvw, K, D), rn(Hkvw, K, D)
    col, row = torch.arange(K, device="cuda")[None], torch.arange(T, device="cuda")[:, None]
    for ctx_len in (2000, 384):
        mask = ~(((col >= s0) & (col - s0 > row)) | ((col >= sink + ctx_len) & (col < s0)))

        def k9():
            return windowed_attend.windowed_attend(q, keys, vals, ctx_len, sink=sink,
                                                   s_ctx=s_ctx, scale=scale)

        emit(dict(kernel="windowed_attend", T=T, ctx_len=ctx_len, ms=graph_ms(k9, 10),
                  sdpa_ms=graph_ms(lambda: sdpa(q, keys, vals, mask), 10),
                  kernels=kernel_us(k9, 5)))


def k2_rows(emit, rn, scale):
    import torch

    from kvzip_tpu_torch.ops import score_kernel

    # K2 at a scoring chunk of qwen2.5-7b (G 7) and llama3.1-8b (G 4)
    T, s_ctx, ctx_len, q_valid, sink = 2304, 2048, 2000, 2060, 160
    for Hq, Hkv in ((H, HKV), (32, 8)):
        q, keys = rn(T, Hq, D), rn(Hkv, sink + s_ctx + T, D)

        def k2():
            return score_kernel.fused_scores(q, keys, ctx_len, q_valid, sink=sink, s_ctx=s_ctx,
                                             scale=scale, model_dtype=torch.bfloat16)

        emit(dict(kernel="fused_scores", H=Hq, Hkv=Hkv, T=T, q_valid=q_valid, ctx_len=ctx_len,
                  ms=graph_ms(k2, 10), kernels=kernel_us(k2, 5)))


def k5d_rows(emit, rn, scale):
    import torch

    from kvzip_tpu_torch.ops import flash_int4

    # K5's decode form: T new rows after the prefill, 28 layers cycled
    layers = [(*quant(rn, HKV, CAPACITY), *quant(rn, HKV, CAPACITY)) for _ in range(L)]
    lens = torch.full((HKV,), PREFILL, dtype=torch.int32, device="cuda")
    for T in (1, 4, 16):
        q = rn(T, H, D)
        cyc = iter(range(10 ** 9))

        def k5d():
            return flash_int4.flash_attend_int4(q, *layers[next(cyc) % L], lens, scale=scale)

        emit(dict(kernel="flash_attend_int4_decode", T=T, live=PREFILL + T, ms=graph_ms(k5d, 56),
                  kernels=kernel_us(k5d, 56)))
    del layers
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
