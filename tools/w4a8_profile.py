#!/usr/bin/env python3
"""Device-time breakdown of the port's W4A8 linears at the shapes of
``chip_smoke.py``: K8 (``w4a8_matmul_stacked_v2``) on qwen2.5-7b's four v2
linears (qkv 3584 -> 4608, o 3584 -> 3584, gate/up 3584 -> 37888, down
18944 -> 3584) as 28-layer stacks at T 1, 4, 16, 24, 256 and 511, and on
the int4 lm_head (3584 -> 152,064) at T 1; K15 (``w4a8_matmul_stacked``)
and K16 (``w4a8_matmul``) on the seven unfused v1 linears at T 1, 24 and
511 (K16 at T 1 and 24, with a bias); K12 (``w4a8_layer_fused``) on the
four v2 stacks at T 1, 4 and 8, beside the composed chain the port runs
without it (four K8 calls, two RMSNorms, SiLU * up and the residual adds,
``chip_smoke.py::kernel_parity_fused``'s ``composed``).

    python3 tools/w4a8_profile.py [--root DIR] [--out FILE] [--only k8,k15,k12] [--tokens 1,4]

``--root`` imports ``kvzip_tpu_torch`` from another checkout (for example
a parent commit unpacked with ``git archive``), so two versions can be
timed in one run on one card. For each shape it prints one JSON line: the
wrapper's device time from a CUDA-graph replay (``graph_ms``, as the smoke
takes it), the bound (weight bytes plus activations over 3.35 TB/s, or
2 T IN OUT int8 operations over 1,979 TOP/s, the larger), and the device
time of each CUDA kernel the wrapper launches, from ``torch.profiler``
over eager calls (``kernels``: name -> mean us per wrapper call). Calls at
T < 256 cycle through the 28 layers, so each call reads its weights from
device memory (a layer's stacks exceed the 50 MB L2 only for gate/up and
down; the cycle keeps every shape alike). Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

L = 28
D, I, H, HKV, DH, VOCAB = 3584, 18944, 28, 4, 128, 152064
V2 = dict(wqkv=(D, (H + 2 * HKV) * DH), wo=(H * DH, D), w_gateup=(D, 2 * I), w_down=(I, D))
V1 = dict(wq=(D, H * DH), wk=(D, HKV * DH), wv=(D, HKV * DH), wo=(H * DH, D), w_gate=(D, I),
          w_up=(D, I), w_down=(I, D))
PEAK_BYTES, PEAK_INT8 = 3.35e12, 1979e12


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


def bound_ms(T, IN, OUT, weight_bytes):
    t_bytes = (weight_bytes + 2 * T * IN + 2 * T * OUT) / PEAK_BYTES
    t_ops = 2 * T * IN * OUT / PEAK_INT8
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="k8,k15,k12", help="comma-separated sections to run")
    ap.add_argument("--tokens", default=None, help="comma-separated T to time K8 at (all if unset)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from kvzip_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    logs = _build.build_all(("w4a8", "w4a8_v1", "w4a8_fused", "fused_act"))
    rows = [dict(card=card, root=os.path.abspath(args.root), torch=torch.__version__,
                 cuda=torch.version.cuda,
                 ptxas=[ln.strip() for lg in logs.values() for ln in lg.splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling" in ln])]
    print(json.dumps(rows[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def emit(r):
        rows.append(r)
        print(json.dumps(r), flush=True)

    if "k8" in only:
        k8_rows(emit, gen, None if args.tokens is None else
                tuple(int(t) for t in args.tokens.split(",")))
    if "k15" in only:
        k15_rows(emit, gen)
    if "k12" in only:
        k12_rows(emit, gen)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


def v2_stack(n_layers, IN, OUT, gen):
    """Random v2 bytes and scales (the kernel's work does not depend on
    them), as ``chip_smoke.py`` makes them."""
    import torch

    half, Gp8 = OUT // 2, -(-IN // 128 // 8) * 8
    return dict(q4=torch.randint(0, 256, (n_layers, IN, half), dtype=torch.uint8, device="cuda",
                                 generator=gen),
                s2=(torch.rand(n_layers, 2, Gp8, half, device="cuda", generator=gen) * 0.002
                    ).to(torch.bfloat16),
                z2=(-0.03 + 0.002 * torch.randn(n_layers, 2, Gp8, half, device="cuda",
                                                generator=gen)).to(torch.bfloat16))


def k8_rows(emit, gen, tokens=None):
    import torch

    from kvzip_tpu_torch.ops import w4a8_v2

    shapes = [(n, IN, OUT, L) for n, (IN, OUT) in V2.items()] + [("lm_head", D, VOCAB, 1)]
    for name, IN, OUT, n_layers in shapes:
        w = v2_stack(n_layers, IN, OUT, gen)
        half, Gp8 = OUT // 2, w["s2"].shape[2]
        weight_bytes = IN * half + 2 * 2 * 2 * Gp8 * half
        for T in ((1,) if name == "lm_head" else tokens or (1, 4, 16, 24, 256, 511)):
            x = (torch.randn(T, IN, device="cuda", generator=gen)).to(torch.bfloat16)
            cyc = iter(range(10 ** 9))

            def k8():
                return w4a8_v2.w4a8_matmul_stacked_v2(x, w["q4"], w["s2"], w["z2"],
                                                      next(cyc) % n_layers)

            b = bound_ms(T, IN, OUT, weight_bytes)
            iters = 56 if T <= 24 else 10
            emit(dict(kernel="w4a8_matmul_stacked_v2", shape=name, IN=IN, OUT=OUT, T=T,
                      ms=graph_ms(k8, iters), bound_ms=b[0], bound_by=b[1],
                      kernels=kernel_us(k8, iters)))
        del w
        torch.cuda.empty_cache()


def v1_stack(n_layers, IN, OUT, gen):
    """A v1 stack as ``chip_smoke.py::v1_stack`` makes it."""
    import torch

    G = IN // 128
    Gp = -(-G // min(16, G)) * min(16, G)
    q4 = torch.randint(0, 256, (n_layers, Gp * 128, OUT // 2), dtype=torch.uint8, device="cuda",
                       generator=gen)
    q4[:, IN:] = 0
    s = 0.0043 * (0.75 + 0.5 * torch.rand(n_layers, Gp, OUT, device="cuda", generator=gen))
    s[:, G:] = 0
    return dict(q4=q4, s=s.to(torch.bfloat16), z=(-7.5 * s).to(torch.bfloat16))


def k15_rows(emit, gen):
    import torch

    from kvzip_tpu_torch.ops import w4a8

    step = {}
    for name, (IN, OUT) in V1.items():
        w = v1_stack(L, IN, OUT, gen)
        slices = [{k: v[l] for k, v in w.items()} for l in range(L)]
        G = IN // 128
        weight_bytes = IN * OUT // 2 + 2 * 2 * G * OUT
        for T in (1, 24, 511):
            x = (torch.randn(T, IN, device="cuda", generator=gen)).to(torch.bfloat16)
            cyc = iter(range(10 ** 9))

            def k15():
                return w4a8.w4a8_matmul_stacked(x, w["q4"], w["s"], w["z"], next(cyc) % L)

            b = bound_ms(T, IN, OUT, weight_bytes)
            iters = 56 if T == 1 else 10
            r = dict(kernel="w4a8_matmul_stacked", shape=name, IN=IN, OUT=OUT, T=T,
                     ms=graph_ms(k15, iters), bound_ms=b[0], bound_by=b[1],
                     kernels=kernel_us(k15, iters))
            if T < 511:
                bias = (0.1 * torch.randn(OUT, device="cuda", generator=gen)).to(torch.bfloat16)
                r["k16_ms"] = graph_ms(lambda: w4a8.w4a8_matmul(
                    x, *(slices[next(cyc) % L][k] for k in ("q4", "s", "z")), bias), iters)
            emit(r)
            for k in ("ms", "k16_ms", "bound_ms"):
                if k in r:
                    step[(T, k)] = step.get((T, k), 0.0) + r[k]
        del w, slices
        torch.cuda.empty_cache()
    for T in (1, 24, 511):  # a decode step's seven linears, summed
        emit(dict(kernel="w4a8_matmul_stacked", shape="seven v1 linears", T=T,
                  **{k: v for (t, k), v in step.items() if t == T}))


def k12_rows(emit, gen):
    """K12 at T 1, 4 and 8 cycling over the 28 layers (the next layer's qkv,
    as the forward passes it), and the composed chain of today's kernels
    on the same stacks and rows: ``graph_ms`` of each and the device us of
    each CUDA kernel a call launches. Bound: the four weight slices and
    their scales, the rows read and written, over 3.35 TB/s."""
    import torch
    import torch.nn.functional as F

    from kvzip_tpu_torch.models.transformer import rms_norm
    from kvzip_tpu_torch.ops import w4a8_fused
    from kvzip_tpu_torch.ops.w4a8 import w4a8_linear_stacked

    HD, QKV, eps = H * DH, (H + 2 * HKV) * DH, 1e-6
    ws = []
    for IN, OUT in ((HD, D), (D, 2 * I), (I, D), (D, QKV)):
        half, Gp8 = OUT // 2, -(-IN // 128 // 8) * 8
        s = 0.0043 * (0.75 + 0.5 * torch.rand(L, 2, Gp8, half, device="cuda", generator=gen))
        z = -7.5 * s
        s[:, 0] /= 16.0
        z[:, 0] += 8.0 * 16.0 * s[:, 0]
        ws.append(dict(q4=torch.randint(0, 256, (L, IN, half), dtype=torch.uint8,
                                        device="cuda", generator=gen),
                       s2=s.to(torch.bfloat16), z2=z.to(torch.bfloat16)))
    w_o, w_gu, w_dn, w_qkv = ws
    lnm = (1 + 0.1 * torch.randn(L, D, device="cuda", generator=gen)).to(torch.bfloat16)
    lna = (1 + 0.1 * torch.randn(L, D, device="cuda", generator=gen)).to(torch.bfloat16)
    nbytes = sum(w["q4"][0].numel() + 2 * 2 * w["s2"][0].numel() for w in ws)
    cyc = iter(range(10 ** 9))

    def fused(x, attn):
        l = next(cyc) % L
        return w4a8_fused.w4a8_layer_fused(x, attn, lnm, lna, *ws, l, eps=eps,
                                           qkv_layer=min(l + 1, L - 1))

    def composed(x, attn):
        l = next(cyc) % L
        x1 = x + w4a8_linear_stacked(attn, w_o, l)
        gate, up = w4a8_linear_stacked(rms_norm(x1, lnm[l], eps), w_gu, l).chunk(2, dim=-1)
        x2 = x1 + w4a8_linear_stacked(F.silu(gate) * up, w_dn, l)
        nxt = min(l + 1, L - 1)
        return x2, w4a8_linear_stacked(rms_norm(x2, lna[nxt], eps), w_qkv, nxt)

    for T in (1, 4, 8):
        x = (0.5 * torch.randn(T, D, device="cuda", generator=gen)).to(torch.bfloat16)
        attn = (0.3 * torch.randn(T, HD, device="cuda", generator=gen)).to(torch.bfloat16)
        io = 2 * T * (D + HD + D + QKV) + 2 * 2 * D
        emit(dict(kernel="w4a8_layer_fused", T=T, ms=graph_ms(lambda: fused(x, attn), 56),
                  composed_ms=graph_ms(lambda: composed(x, attn), 56),
                  bound_ms=(nbytes + io) / PEAK_BYTES * 1e3, bound_by="bytes",
                  kernels=kernel_us(lambda: fused(x, attn), 28),
                  composed_kernels=kernel_us(lambda: composed(x, attn), 28)))
    del ws, w_o, w_gu, w_dn, w_qkv
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
