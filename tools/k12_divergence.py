#!/usr/bin/env python3
"""Where K12 (``w4a8_layer_fused``) first leaves its plain version, on the
inputs ``chip_smoke.py::kernel_parity_fused`` gives it (qwen2.5-7b's
widths, 28-layer stacks from the smoke's seed, the next layer's qkv).

    python3 tools/k12_divergence.py [--T 8] [--layer 14]

Runs K12 once, keeps the scratch it allocates (the hidden rows h and their
row maxima are still there after the launch), repeats the plain version's
steps up to h, and prints one JSON line: the card, how many h values and
which rows differ, the row maxima of both, and the largest differences.
A whole row of h off by bf16 steps points at that row's s8 scale before
gate/up (the rounding of the row's largest normalized x1 value); a few
scattered values at single roundings. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=8, choices=(1, 4, 8))
    ap.add_argument("--layer", type=int, default=14)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from kvzip_tpu_torch.config import resolve_config
    from kvzip_tpu_torch.ops import w4a8_fused as wf

    cfg = resolve_config("qwen2.5-7b")
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    HD, eps, l = cfg.num_heads * cfg.head_dim, cfg.rms_norm_eps, args.layer
    # the smoke's draws, in its order: the stacks, the two norms, then x and
    # attn for T 1, 4 and 8
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 5)
    ws = chip_smoke.fused_stacks(cfg, gen)

    def rn(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)

    lnm, lna = 1 + rn(L, D, std=0.1), 1 + rn(L, D, std=0.1)
    rows = {T: (rn(T, D, std=0.5), rn(T, HD, std=0.3)) for T in (1, 4, 8)}
    x, attn = rows[args.T]
    T = args.T

    made, real = [], torch.empty

    def keep(*a, **k):
        t = real(*a, **k)
        made.append(t)
        return t

    torch.empty = keep
    try:
        wf.w4a8_layer_fused(x, attn, lnm, lna, *ws, l, eps=eps, qkv_layer=min(l + 1, L - 1))
    finally:
        torch.empty = real
    torch.cuda.synchronize()
    h_k = next(t for t in made if tuple(t.shape) == (T, I) and t.dtype == torch.float32)
    hmax_k = next(t for t in made if tuple(t.shape) == (T,) and t.dtype == torch.int32)
    hmax_k = hmax_k.view(torch.float32)

    def rnd(v):
        return v.to(x.dtype).float()

    aq, s = wf._quant(attn.float())
    x1 = rnd(x.float() + rnd(wf._product(aq, ws[0], l) * s))
    var = (x1 * x1).mean(dim=-1, keepdim=True)
    hq, s1 = wf._quant(rnd(x1 * torch.rsqrt(var + eps) * lnm[l].float()))
    gu = wf._product(hq, ws[1], l) * s1
    gate, up = rnd(gu[:, :I]), rnd(gu[:, I:])
    h = rnd(gate * torch.sigmoid(gate) * up)
    diff = h != h_k
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card, T=T, layer=l, h_values=h.numel(),
                          h_differ=int(diff.sum()), h_differ_by_row=diff.sum(dim=1).tolist(),
                          hmax_plain=h.abs().amax(dim=-1).tolist(), hmax_kernel=hmax_k.tolist(),
                          largest=(h - h_k).abs().flatten().topk(5).values.tolist())), flush=True)


if __name__ == "__main__":
    main()
