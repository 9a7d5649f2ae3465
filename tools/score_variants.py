#!/usr/bin/env python3
"""Where K2's time goes: ``csrc/score.cu`` rebuilt with one change at a
time and timed at the smoke's scoring chunk (2,304 repeat queries, a
2,048-row window, ctx_len 2,000, q_valid 2,060, a 160-row sink) at
qwen2.5-7b's heads (28 over 4) and llama3.1-8b's (32 over 8), ``graph_ms``.

    python3 tools/score_variants.py [--out FILE] [--only a,b,...] [--max-rows 256,128]

Each variant is the source with a text substitution (``VARIANTS``), built
with the port's nvcc flags into a temporary directory and called through
its C entry with the wrapper's arguments (``score_kernel.plan``'s block,
its cap on a CTA's rows from ``--max-rows``, at most the kernel's 256).
Variants that drop work print their time only; the others are also held
against the plain version (``ops.parity``). Needs a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, S_CTX, CTX_LEN, Q_VALID, SINK, D = 2304, 2048, 2000, 2060, 160, 128

_ROUND_F2FP = """    const uint32_t u = kvz::pack_f32(sc[2 * j] * scale, sc[2 * j + 1] * scale);
    sc[2 * j] = __uint_as_float(u << 16);
    sc[2 * j + 1] = __uint_as_float(u & 0xffff0000u);"""
# round to nearest even on the float bits: no conversion instruction
_ROUND_INT = """    uint32_t a = __float_as_uint(sc[2 * j] * scale), b = __float_as_uint(sc[2 * j + 1] * scale);
    a = (a + 0x7fffu + ((a >> 16) & 1u)) & 0xffff0000u;
    b = (b + 0x7fffu + ((b >> 16) & 1u)) & 0xffff0000u;
    sc[2 * j] = __uint_as_float(a);
    sc[2 * j + 1] = __uint_as_float(b);"""
_EXP = "acc[e >> 1][j & 1] += sm90::ex2(fmaf(sc[j * 4 + e], LOG2E, -mu[e >> 1]));"
_REFILL = "if (threadIdx.x == 0 && i >= 1 && j < plan.n) {"
_FIRST = "for (int i = 0; i < min(NSTAGE, plan.n); ++i) load_tile(i);"
_PASS2 = "  for (int i = plan.n1; i < plan.n; ++i) {\n    refill(i);"
# the kernel's own masks: edge tiles only, behind a branch on the
# (CTA-uniform) tile
_MASK_BRANCH = """      if (msk) {
        const int lim[2] = {rep < 0 ? plan.lim_a - i * BKT : qrow[u][0] - rep * BKT + 1,
                            rep < 0 ? plan.lim_a - i * BKT : qrow[u][1] - rep * BKT + 1};
        mask_cols(sc, lim, tig);
      }"""
_MASK_SELECT = """      const int all = 1 << 30;
      const int lim[2] = {!msk ? all : rep < 0 ? plan.lim_a - i * BKT : qrow[u][0] - rep * BKT + 1,
                          !msk ? all : rep < 0 ? plan.lim_a - i * BKT : qrow[u][1] - rep * BKT + 1};
      mask_cols(sc, lim, tig);"""
_P1_WAIT = "      if (u + 1 < RTW) sm90::wgmma_wait<1>(); else sm90::wgmma_wait<0>();"
_P2_WAIT = "      if (k + 1 < RTW) sm90::wgmma_wait<1>(); else sm90::wgmma_wait<0>();"
_P1_ARRIVE = "      if (u + 1 == RTW && lane == 0) sm90::mbar_arrive(&empty[s]);"
_P2_ARRIVE = "      if (k == RTW - 1 && lane == 0) sm90::mbar_arrive(&empty[s]);"
_P1_ALU = "      round_logits(sc, scale);\n      // edge tiles only"

# pass 1's exponentials two at a time, ex2.approx.f16x2 on the rounded
# arguments, summed in float32
_EXP_LOOP = """#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e >> 1][j & 1] += sm90::ex2(fmaf(sc[j * 4 + e], LOG2E, -mu[e >> 1]));"""
_EXP_F16 = """#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const __half2 a = __floats2half2_rn(fmaf(sc[j * 4 + e], LOG2E, -mu[e >> 1]),
                                          fmaf(sc[j * 4 + e + 1], LOG2E, -mu[e >> 1]));
      const float2 p = __half22float2(h2exp2(a));
      acc[e >> 1][j & 1] += p.x + p.y;
    }"""

# name -> (substitutions, keeps the function). Measured before and left
# out of the source (PERF.md, PR 12): 64-key half tiles, three consumer
# warpgroups, 512 rows a CTA, a producer warpgroup or warp, a write-only
# first step of each product.
VARIANTS = {
    "as_is": ([], True),
    "int_round": ([(_ROUND_F2FP, _ROUND_INT)], True),
    # the masks as a select an element on every tile, no branch
    "mask_select": ([(_MASK_BRANCH, _MASK_SELECT)], True),
    # one empty-barrier arrival a consumer thread instead of a warp
    "thread_arrive": ([("sm90::mbar_init(&empty[s], 4 * CWG);", "sm90::mbar_init(&empty[s], 128 * CWG);"),
                       (_P1_ARRIVE, "      if (u + 1 == RTW) sm90::mbar_arrive(&empty[s]);"),
                       (_P2_ARRIVE, "      if (k == RTW - 1) sm90::mbar_arrive(&empty[s]);")],
                      True),
    # each row tile (pass 1) or Q chunk (pass 2) waits for every issued
    # product: no product runs while scores are used
    "serial": ([(_P1_WAIT, "      sm90::wgmma_wait<0>();"),
                (_P2_WAIT, "      sm90::wgmma_wait<0>();")], True),
    "f16_exp": ([(_EXP_LOOP, _EXP_F16)], True),
    # ablations
    "no_exp": ([(_EXP, _EXP.replace("sm90::ex2(", "("))], False),
    "p1_tensor_only": ([(_P1_ALU, "      // edge tiles only"),
                        ("      row_stats(sc, m[u], l[u]);", "      m[u][0] = fmaxf(m[u][0], sc[0]);"),
                        ("        mask_cols(sc, lim, tig);\n      }", "      }")], False),
    "pass1_only": ([(_REFILL, _REFILL.replace("plan.n)", "plan.n1)")),
                    (_FIRST, _FIRST.replace("plan.n)", "plan.n1)")),
                    (_PASS2, _PASS2.replace("i < plan.n;", "i < plan.n1;")),
                    ("  // pass 2: the window columns'",
                     "  if (lse[0][0] == 1.f) out[threadIdx.x] = lse[0][1];\n  // pass 2: the window columns'")],
                   False),
}


def build(name, subs, tmp):
    csrc = os.path.join(ROOT, "kvzip_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "score.cu")).read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    cu = os.path.join(tmp, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    from kvzip_tpu_torch import _build
    so = os.path.join(tmp, f"lib{name}.so")
    return so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None, help="comma-separated variants")
    ap.add_argument("--max-rows", default=None,
                    help="comma-separated caps on a CTA's (query, head) rows for the plan")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    from kvzip_tpu_torch.ops import SCORE_RTOL, parity, score_kernel
    from tools.attn_profile import graph_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    only = args.only.split(",") if args.only else list(VARIANTS)
    jobs = {n: build(n, subs, tmp) for n, (subs, _) in VARIANTS.items() if n in only}
    libs = {}
    for n, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps(dict(variant=n, build_failed=log[-3000:])), flush=True)
            continue
        fn = ctypes.CDLL(so).kvz_fused_scores
        fn.argtypes = score_kernel._ARGS
        fn.restype = ctypes.c_int
        libs[n] = (fn, [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln or "Performance" in ln
                        or "serialized" in ln])

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [dict(card=card)]
    kw = dict(sink=SINK, s_ctx=S_CTX, scale=D ** -0.5, model_dtype=torch.bfloat16)
    for H, Hkv in ((28, 4), (32, 8)):
        K = SINK + S_CTX + T
        q = torch.randn(T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        keys = torch.randn(Hkv, K, D, generator=gen, device="cuda").to(torch.bfloat16)
        want = score_kernel.fused_scores_plain(q.float(), keys.float(), CTX_LEN, Q_VALID, **kw)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        out = torch.empty((Hkv, S_CTX), dtype=torch.float32, device="cuda")
        caps = [score_kernel.MAX_ROWS] if args.max_rows is None else map(int, args.max_rows.split(","))
        for (n, (fn, regs)), max_rows in ((v, m) for m in caps for v in libs.items()):
            nq = score_kernel.plan(H // Hkv, Hkv, Q_VALID, sms, max_rows)
            def call(fn=fn):
                err = fn(q.data_ptr(), keys.data_ptr(), out.data_ptr(), T, H, Hkv, K, SINK,
                         S_CTX, CTX_LEN, Q_VALID, nq, D ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return out

            r = dict(variant=n, H=H, Hkv=Hkv, nq=nq, max_rows=max_rows, ptxas=regs)
            if VARIANTS[n][1]:
                got = call().clone()
                torch.cuda.synchronize()
                p = parity(got, want, SCORE_RTOL)
                r.update(parity_ok=p["ok"], worst_to_tol=p["worst_to_tol"])
            r["ms"] = graph_ms(call, 10)
            rows.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
