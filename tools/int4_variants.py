#!/usr/bin/env python3
"""Design variants of the int4 flash body (K5's prefill form and K6,
``csrc/flash_int4.cu``), each the source with a text substitution
(``VARIANTS``; a function for the one that rewrites whole blocks), built with
the port's nvcc flags into a temporary directory and called through its C
entries with the wrappers' arguments.

    python3 tools/int4_variants.py [--only a,b] [--out FILE]

For each variant it prints one JSON line: ptxas's register and spill line
of the wgmma kernel, and at qwen2.5-7b's shapes (28 heads over 4 kv heads,
head_dim 128) K5 at 4,096 queries after 12,288 rows and K6 at a 2,304-query
chunk after 16,544 rows: the device time of a CUDA-graph replay
(``graph_ms``) and ``ops.parity`` against the plain version, plus parity
at a small case whose 128-key tiles wrap both rings many times (T 1,024
after 5,000 rows, 4 heads over 2). Needs a card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, HKV, D, CAPACITY, PREFILL = 28, 4, 128, 19456, 16544

_PRODUCER_LOOP = "#pragma unroll\n      for (int k = 0; k < 8; ++k) {  // 4 16-byte chunks"
_NO_SETMAXNREG = [("    sm90::regs_dealloc<PRODUCER_REGS>();\n", ""),
                  ("  sm90::regs_alloc<CONSUMER_REGS>();\n", "")]
_UNROLL_1 = (_PRODUCER_LOOP, _PRODUCER_LOOP.replace("unroll", "unroll 1"))

_SYNC_FOLD = "      if ((j & 3) == 3) __syncwarp();  // at most 4 float4 of scales in flight\n"
_SYNC_PACK = "      if ((j & 3) == 3) __syncwarp();\n"


def _regs(p, c):
    return ("PRODUCER_REGS = 88, CONSUMER_REGS = 208", f"PRODUCER_REGS = {p}, CONSUMER_REGS = {c}")


# rows derived from the block index where they are used, not held
_ROWS_LATE = [
    ("  const int row_lo = q0 + r_lo, row_hi = row_lo + 8;\n", ""),
    ("      fsm90::mask_tile(sc, Lim{meta.y, meta.z, meta.w}, meta.x, tig, row_lo, row_hi);",
     "      fsm90::mask_tile(sc, Lim{meta.y, meta.z, meta.w}, meta.x, tig,\n"
     "                       (gridDim.y - 1 - blockIdx.y) * BQ + r_lo,\n"
     "                       (gridDim.y - 1 - blockIdx.y) * BQ + r_lo + 8);"),
    ("  fsm90::store_rows(o, l, zs, out, row_lo, row_hi, T, H, h, tig);",
     "  fsm90::store_rows(o, l, zs, out, q0 + r_lo, q0 + r_lo + 8, T, H, h, tig);"),
]

# Expansion by the consumers instead of the producer warpgroup: the
# producer only issues TMA (40 registers, two packed stages whose empty
# barriers are ex_empty); each tile, the 256 consumer threads expand the
# packed stage into one bf16 stage between two named barriers, then run
# wgmma on it as before.
_CONSUMER_EXPAND_PRODUCER = """    // ------------------------------------------------ producer (TMA only)
    sm90::regs_dealloc<40>();
    const int h = blockIdx.x, hk = h / G;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const Int4Plan plan(base_lens[hk], C, T, q0, sc_in.xks != nullptr);
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_full, TILE);
      sm90::tma_load_2d(smem + I4_Q, &qmap, q_full, h * D, q0);
      sm90::tma_load_2d(smem + I4_Q + HALF, &qmap, q_full, h * D + 64, q0);
      for (int i = 0; i < plan.n; ++i) {
        const int ps = i % P_STAGES;
        if (i >= P_STAGES) sm90::mbar_wait(&ex_empty[ps], ((i / P_STAGES) - 1) & 1);
        issue_packed(plan.tile(i), smem + I4_PK + ps * 2 * PK, &pk_full[ps], &kmap, &vmap,
                     &xkmap, &xvmap, hk);
      }
    }
    return;
  }
"""
_CONSUMER_EXPAND_LOOP = """  const Int4Plan plan(base_lens[h / G], C, T, q0, sc_in.xks != nullptr);
  const int t256 = threadIdx.x - 128, hk = h / G, Hkv = H / G;
  for (int i = 0; i < n_live; ++i) {
    const int es = 0, ps = i % P_STAGES;
    const Int4Tile x = plan.tile(i);
    float2 kf2 = make_float2(0.f, 0.f), vf2 = make_float2(0.f, 0.f);
    const int row = x.t * BKT + t256;
    if (t256 < BKT && row < plan.rows(x.src)) {
      const size_t g = x.src ? static_cast<size_t>(row) * Hkv + hk
                             : static_cast<size_t>(hk) * C + row;
      const float kss = __bfloat162float((x.src ? sc_in.xks : sc_in.ks)[g]);
      const float kzz = __bfloat162float((x.src ? sc_in.xkz : sc_in.kz)[g]);
      const float vss = __bfloat162float((x.src ? sc_in.xvs : sc_in.vs)[g]);
      const float vzz = __bfloat162float((x.src ? sc_in.xvz : sc_in.vz)[g]);
      kf2 = make_float2(kss * scale_log2, fmaf(8.f, kss, kzz) * scale_log2);
      vf2 = make_float2(vss, fmaf(8.f, vss, vzz));
    }
    sm90::named_bar(2, 256);  // both warpgroups are done with the bf16 stage
    sm90::mbar_wait(&pk_full[ps], (i / P_STAGES) & 1);
    {
      const uint8_t* pk = smem + I4_PK + ps * 2 * PK;
      uint8_t* ex = smem + I4_EX;
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // 2 16-byte chunks of K, then 2 of V
        const int idx = t256 + 256 * (k & 1), r = idx >> 2, jc = idx & 3, sw = r & 7;
        const uint4 w = *reinterpret_cast<const uint4*>(pk + (k >> 1) * PK + idx * 16);
        uint8_t* dst = ex + (k >> 1) * TILE + r * 128;
        uint4 hi, lo;
        expand8(w.x, w.y, hi, lo);
        *reinterpret_cast<uint4*>(dst + (((2 * jc) ^ sw) << 4)) = hi;
        *reinterpret_cast<uint4*>(dst + HALF + (((2 * jc) ^ sw) << 4)) = lo;
        expand8(w.z, w.w, hi, lo);
        *reinterpret_cast<uint4*>(dst + (((2 * jc + 1) ^ sw) << 4)) = hi;
        *reinterpret_cast<uint4*>(dst + HALF + (((2 * jc + 1) ^ sw) << 4)) = lo;
      }
      if (t256 < BKT) {
        float2* scs = reinterpret_cast<float2*>(smem + I4_SC);
        scs[t256] = kf2;
        scs[BKT + t256] = vf2;
      }
      if (t256 == 0)
        *reinterpret_cast<int4*>(smem + I4_META) =
            tile_meta(x.t * BKT, plan.full(x), plan.lim(x.src));
      sm90::fence_proxy_async_shared();
      sm90::mbar_arrive(&ex_empty[ps]);  // the packed stage is free
    }
    sm90::named_bar(2, 256);  // the bf16 tile is whole
    const uint8_t* ks = smem + I4_EX;
    const float4* kf = reinterpret_cast<const float4*>(smem + I4_SC);
    const float4* vf = kf + BKT / 2;

    float sc[64];
    fsm90::qk_tile(sc, qd0, qd1, ks);
"""
_P_HEAD = "    // ------------------------------------------------ producer / expansion\n"
_C_HEAD = "  // -------------------------------------------------------------- consumers\n"
_LOOP_HEAD = """  for (int i = 0; i < n_live; ++i) {
    const int es = i % E_STAGES;
    const uint8_t* ks = smem + I4_EX + es * 2 * TILE;
    const float4* kf = reinterpret_cast<const float4*>(smem + I4_SC + es * SC_STAGE);
    const float4* vf = kf + BKT / 2;

    float sc[64];
    sm90::mbar_wait(&ex_full[es], (i / E_STAGES) & 1);
    fsm90::qk_tile(sc, qd0, qd1, ks);
"""


def _consumer_expand(src):
    a, b = src.index(_P_HEAD), src.index(_C_HEAD)
    src = src[:a] + _CONSUMER_EXPAND_PRODUCER + "\n" + src[b:]
    src = src.replace("    sm90::mbar_arrive(&ex_empty[es]);\n  }\n", "  }\n")
    src = src.replace("constexpr int P_STAGES = 3;", "constexpr int P_STAGES = 2;")
    return src.replace(_LOOP_HEAD, _CONSUMER_EXPAND_LOOP)


VARIANTS = {
    "as_is": [],
    "consumer_expand": _consumer_expand,
    "producer_unroll_1": [_UNROLL_1],
    "no_syncwarp": [(_SYNC_FOLD + "    }", "    }"), (_SYNC_PACK + "    }", "    }")],
    "regs_72_216": [_regs(72, 216)],
    "regs_104_200": [_regs(104, 200)],
    "diag_no_setmaxnreg": _NO_SETMAXNREG,
}


def build(name, subs, tmp):
    csrc = os.path.join(ROOT, "kvzip_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "flash_int4.cu")).read()
    if callable(subs):
        src = subs(src)
    else:
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


def sass_spills(so, keep=None):
    """STL/LDL instructions of the wgmma kernel's SASS in the consumer
    warpgroups' code (laid out before the producer's USETMAXREG.DEALLOC)
    and in the producer's (after it); the kernel's SASS is written to
    ``keep`` where given."""
    from kvzip_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", so], capture_output=True, text=True).stdout
    out, fn, region, lines = {"consumer": 0, "producer": 0}, None, "consumer", []
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn, region = ln, "consumer"
        elif fn and "wgmma_kernel" in fn:
            lines.append(ln.strip())
            if "USETMAXREG.DEALLOC" in ln:
                region = "producer"
            elif "STL" in ln or "LDL" in ln:
                out[region] += 1
    if keep:
        with open(keep, "w") as f:
            f.write("\n".join(lines))
    return out


def wgmma_ptxas(log):
    """ptxas's lines of the wgmma kernel: entry, spills, registers."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "wgmma_kernel" in ln
        if keep and ("spill" in ln or "registers" in ln):
            out.append(ln.strip())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=None, help="comma-separated variants")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, ROOT)
    from kvzip_tpu_torch.ops import OUT_RTOL, flash_int4, parity
    from kvzip_tpu_torch.ops.quant import quantize_int4
    from tools.attn_profile import graph_ms

    tmp = tempfile.mkdtemp()
    only = args.only.split(",") if args.only else list(VARIANTS)
    jobs = {n: build(n, VARIANTS[n], tmp) for n in only}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def quant(*shape):
        p, s_, z = quantize_int4(rn(*shape, D), pack="split")
        return p, s_[..., 0], z[..., 0]

    cases = []  # (name, T, H, Hkv, C, base, extra)
    for nm, T, h, hkv, C, base, extra in (("k5", 4096, H, HKV, CAPACITY, 12288, False),
                                          ("k6", 2304, H, HKV, CAPACITY, PREFILL, True),
                                          ("k5_small", 1024, 4, 2, 8192, 5000, False)):
        q = rn(T, h, D)
        kv = (*quant(hkv, C), *quant(hkv, C))
        x = (*quant(T, hkv), *quant(T, hkv)) if extra else None
        lens = torch.tensor([base - 7 * i for i in range(hkv)], dtype=torch.int32,
                            device="cuda")
        if extra:
            want = flash_int4.flash_attend_int4_extra_plain(q.float(), *kv, lens, *x,
                                                            scale=D ** -0.5)
        else:
            want = flash_int4.flash_attend_int4_plain(q.float(), *kv, lens, scale=D ** -0.5)
        cases.append((nm, q, kv, x, lens, want, T, h, hkv, C))

    rows = []
    for n, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps(dict(variant=n, build_failed=log[-3000:])), flush=True)
            continue
        lib = ctypes.CDLL(so)
        k5, k6 = lib.kvz_flash_int4, lib.kvz_flash_int4_extra
        k5.argtypes, k6.argtypes = flash_int4._ARGS, flash_int4._ARGS_EXTRA
        r = dict(variant=n, ptxas=wgmma_ptxas(log), sass_spills=sass_spills(
            so, args.out and f"{os.path.splitext(args.out)[0]}_{n}.sass"))
        for nm, q, kv, x, lens, want, T, h, hkv, C in cases:
            out = torch.empty_like(q)

            def call():
                stream = torch.cuda.current_stream().cuda_stream  # the capture's own
                ptrs = [t.data_ptr() for t in (q, *kv, lens)]
                if x is None:
                    err = k5(*ptrs, out.data_ptr(), T, h, hkv, C, D ** -0.5, stream)
                else:
                    err = k6(*ptrs, *[t.data_ptr() for t in x], out.data_ptr(), T, h, hkv, C,
                             D ** -0.5, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return out
            call()
            torch.cuda.synchronize()
            p = parity(out, want, OUT_RTOL)
            r[nm] = dict(ok=p["ok"], worst_to_tol=p["worst_to_tol"], rel_rms_err=p["rel_rms_err"])
            if nm != "k5_small":
                r[nm]["ms"] = graph_ms(call, 10)
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
