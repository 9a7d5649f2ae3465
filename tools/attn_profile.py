#!/usr/bin/env python3
"""Device-time breakdown of the port's Hopper attention kernels at the
shapes of ``chip_smoke.py``'s main paths: K1 (``flash_attend``) and K4
(``ragged_decode_attend``) on the bf16 path, K5's prefill form
(``flash_attend_int4``, 4,096 queries after 12,288 rows) and K6
(``flash_attend_int4_extra``, a 2,304-query scoring chunk after 16,544 rows)
on the int4 path (qwen2.5-7b: 28 heads over 4 kv heads, head_dim 128; a
16,544-row prefill in a 19,456-row cache), and K9 (``windowed_attend``) at
llama3.1-8b's windowed pass (32 heads over 8, 2,304 queries, a 2,048-row
window, ctx_len 2,000 and 384, a 40-row sink).

    python3 tools/attn_profile.py [--root DIR] [--out FILE]

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
``k1_ms`` for K1 alone on the dequantized rows). Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

L, H, HKV, D = 28, 28, 4, 128
PREFILL, CAPACITY = 16544, 19456


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
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from kvzip_tpu_torch import _build
    from kvzip_tpu_torch.ops import flash, ragged_decode

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    logs = _build.build_all(("flash", "ragged_decode", "flash_int4", "windowed_attend"))
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

        r = dict(kernel="ragged_decode_attend", T=T, live=S, ms=graph_ms(k4, 56),
                 sdpa_ms=graph_ms(lib, 56), kernels=kernel_us(k4, 56))
        rows.append(r)
        print(json.dumps(r), flush=True)
    del kc, vc

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

        r = dict(kernel="flash_attend", T=T, base=base, ms=graph_ms(k1, 10),
                 sdpa_ms=graph_ms(lambda: sdpa(q, ke, ve, mask), 10), kernels=kernel_us(k1, 5))
        rows.append(r)
        print(json.dumps(r), flush=True)
        del ke, ve, mask
    del k, v

    # K5's prefill form and K6 on int4 rows, beside dequantize-then-K1
    from kvzip_tpu_torch.ops import flash_int4, windowed_attend
    from kvzip_tpu_torch.ops.quant import dequantize_int4, quantize_int4

    def quant(*shape):
        p, s_, z = quantize_int4(rn(*shape, D), pack="split")
        return p, s_[..., 0], z[..., 0]

    def deq(p, s_, z):
        return dequantize_int4(p, s_[..., None], z[..., None], torch.bfloat16, pack="split")

    kv = (*quant(HKV, CAPACITY), *quant(HKV, CAPACITY))
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
            name, extra = "flash_attend_int4_extra", (*quant(T, HKV), *quant(T, HKV))

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
        rows.append(r)
        print(json.dumps(r), flush=True)
    del kv

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

        r = dict(kernel="windowed_attend", T=T, ctx_len=ctx_len, ms=graph_ms(k9, 10),
                 sdpa_ms=graph_ms(lambda: sdpa(q, keys, vals, mask), 10),
                 kernels=kernel_us(k9, 5))
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
