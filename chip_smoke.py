#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kvzip_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Card: prints ``nvidia-smi``'s name and power limit; fails without CUDA.
2. Build: builds the CUDA kernels K1-K16 from ``kvzip_tpu_torch/csrc``
   (thirteen sources, one ``nvcc`` each, all started together), and logs
   (``build_wgmma``) ptxas's register, shared-memory and spill lines for
   the Hopper kernels K1, K2, K4, K5/K6 and K9, with the count of HGMMA
   (wgmma) instructions and the spilled bytes of each wgmma kernel (K1,
   K2, K9 and the int4 body) from its SASS; fewer than 16 HGMMA
   fails the run.
3. Kernel parity: each kernel against its plain PyTorch version (computed
   in float32 from the same inputs) at every shape its main path gives
   it, through ``kvzip_tpu_torch.ops.parity`` (tolerances relative to the
   reference's own size), which must also reject a reference with one
   split of the work left out; with the kernel's, the plain version's and,
   where one PyTorch call computes the same function, that call's time,
   beside the least time the card could take for the work. A kernel's and
   the library call's ``ms`` is device time: CUDA events around the replay
   of a CUDA graph of many calls (``graph_ms``); the event time of the
   same calls made back to back from Python, host gaps included, is logged
   as ``host_ms``. Plain versions are timed back to back. The int8
   attention (K7-q8, K11-q8) is held against its plain version's own s8
   arithmetic, discounting the quantized-p steps that float32 rounding may
   flip (the plain version's ``with_slack``).
   K1 is timed at the prefill's 4,096-query chunk and at a 2,304-query
   scoring window, K4 at T = 1 and 8, each beside SDPA with its mask; K9
   beside SDPA with its bool mask; K5's prefill form and K6 beside the same
   attention computed by dequantizing the live rows and calling K1 (logged
   as ``deq_k1_ms`` and ``k1_ms``). K5's two forms (T > 16, T <= 16) are
   two rows of the kernels line, each with its own launches
   (``LAUNCHES["flash_attend_int4_decode"]`` counts the decode form); the
   decode form timed at T = 1, 4 and 16 (``per_shape``). K2 at qwen2.5-7b's
   and llama3.1-8b's heads (``per_shape``), its bound counting only the
   visible (query, key) pairs, with the floor of its pass-1 exponentials
   beside it (``exp_floor_ms``: one a visible pair, 16 a clock an SM at
   the maximum SM clock ``nvidia-smi`` reports).
   K10/K11 at T = 1 and 24, one and two merged sequences, on an evicted
   and on the full flat stack (``kernel_parity_flat``). K3, K7 and K7-q8
   also with one tail length per kv head (one of them 0); K3 timed at T =
   1, 4, 16 and 24 (``per_shape``); K7 and K7-q8 also over 40 kv heads (a
   merged pool, G 1 and 7). K8 timed at T = 1, 4, 16, 24 and 256. K12, the fused
   W4A8 decode layer, at qwen2.5-7b's shapes, T 1/4/8 at layers 0/14/27,
   beside the device time of the composed chain it replaces
   (``kernel_parity_fused``). K15/K16, the v1 W4A8 linears, at qwen2.5-7b's
   unfused and fused v1 shapes (pad groups included), K15 at T 1/24/511
   and layers 0/14/27 of 28-layer stacks, K16 at T 1/24 with a bias on
   q/k/v (``kernel_parity_w4a8_v1``).
   K13 and K14 also carry their T = 1 time (``t1_ms``) beside T = 2304.
   K1-K7 (K5 in both forms, K7 also in q8 mode) also at a tensor-parallel
   rank's local head counts, 14 over 2 (tp 2) and 7 over 1 (tp 4), at the
   main path's shapes (``kernel_parity_tp_local``), folded into their rows.
4. bf16 main path at the full width of qwen2.5-7b (28 layers, random bf16
   weights from a seed) and a 16384-token context, through the engine's
   entry points: prefill, scoring, a greedy answer on the dense cache,
   an all-rows-kept pool held against it (``allkept_attention`` per layer
   on the real KV, ``allkept_check`` on the logits), prune(0.3, "pair"),
   three queries on the pool, and the full-pool baseline. The launch
   counters are zeroed just before and read just after; K1-K4 must have
   run. Then the legacy flat layout (``flat_decode="legacy"``) on a copy
   of the same scored state (``flat_path``): the same kept rows, three
   queries, the full flat baseline (``synthetic_full_flat_state``), live and
   allocated KV bytes; K10 must have run, exactly once a layer of each
   forward over a flat cache (one kernel a layer, no merge kernel), and
   no pool kernel. The two
   layouts are then held against each other: K10 against K3 layer by
   layer on the real rows (``cross_layout_attention``) and teacher-forced
   logits (``allkept_check`` between pool and flat).
   Then the dense routes on the same engine's weights: ``retain_path``
   (``kv_type="retain"``: one prefill and scoring of the context, pruned at
   pair 0.3, 0.6 and 1.0 on the same state, the three queries each through
   the captured step over the masked route, which must launch nothing;
   ms/token host clock and device beside the pool's; retain 0.3 held
   against a copy of the scored state compacted with ``flat_decode="off"``
   on the same scores: the same rows per head, teacher-forced logits within
   twice the schedule noise; retain 1.0 against the unpruned state),
   ``compact_path`` (that compacted state: K4 at T 1, 8 and K1 at T 16, 24,
   64 held against their plain versions on its far-apart lengths, then the
   three queries with no eos stop, whose K1 and K4 launches must be
   exactly the ladder's), ``head_path`` (the retain state's scores saved
   as head scores, loaded with ``load_score=True``, head 0.6 evicted as a
   lengths update, no row moved; the same kernel holds on its lengths;
   held against the retain state's head 0.6) and ``state_io``
   (``save_state`` of the main path's pool, ``load_state`` into a fresh
   state: arrays, counters and answer equal; seconds, bytes).
   Then ``tp_path``: the same path through ``Engine(mesh=...)``
   (``kvzip_tpu_torch/parallel``) over an NCCL group of the machine's
   cards (at most 4, a divisor of the 4 kv heads; on one card the smoke's
   own process at world size 1, a FileStore, no port), on the bf16
   engine's weights, context and queries: prefill, scoring, prune(0.3,
   "pair"), three queries through the captured step; K1-K4 must launch;
   the pool's rows, the answers and one query's logits held against the
   no-mesh engine's (bit-equal expected at world size 1, within OUT_RTOL
   of the largest logit in any case), the captured step's graph holding
   2L + 1 all-reduces and one all-gather (``ops.COLLECTIVES``); then
   ``ring_prefill`` and ``reshard_to_cache`` called directly on 4,096
   tokens, their K/V within twice the schedule noise of the normal
   prefill's (the same prefill in other chunks; layer 0 equal). On two or more cards one spawned process a card runs
   the same holds (written, unrun: the driver's machine has one card).
   Then batched serving (``kvzip_tpu_torch/serving.py``) on four contexts
   of 8,192 random tokens, each scored once and pruned at pair 0.3, 0.4,
   0.5 and 0.6 into the pool and, from a copy, into the flat layout:
   ``serving_pool`` and ``serving_flat`` (``serving_path``):
   ``batched_generate_ids`` over the four states (the smoke's three
   24-token queries and one more, 32 new tokens), one merged cache and one
   captured decode step for the batch; in that call K3 (K10 at n_seq 4)
   must launch exactly once a layer a merged forward (the ingest and each
   step) and no other kernel; the merged step is held against each
   state's own on the same tokens and counters (``hold_merged``:
   teacher-forced logits along the single-state answer, one token a
   forward, within twice the larger of the single path's schedule noise
   and the merged stack's distance from it at B = 1; argmax at clear
   margins; the merged answer equal up to the first near-tie); every
   state's counters must be back at their snapshot and its next answer
   its first. Reported: the merged step's host-clock and device ms (per
   step and divided by four) beside the sum of the four states' own
   captured decodes; ``batched_generate_ids``' seconds beside the four
   states' own ``generate_ids`` seconds, and the merge's and the
   capture's seconds in it; the memory the merged and single-state graphs
   hold, and the merged cache's bytes (``mem_bytes``).
   ``serving_continuous``: ``Scheduler.run_continuous(segment=8)`` with
   six requests over the four pool states at ``max_batch`` 4 (one
   admitted mid-flight at least), each request held by ``hold_merged``
   (the six in batches of four); each round's batch, admissions and
   capture seconds. ``serving_dense``: four retain states of the same
   contexts (pair 0.3-0.6) through the same ``serving_path``: one dense
   cache over 4 x Hkv heads (``_merge_dense``), the masked route, no kernel
   launched, every request held as above.
5. Quantized main path (the reference's flagship: int4 KV, W4A8 weights,
   int8 embedding and lm_head) at the same width and context, after the
   bf16 engine is freed: prefill, read-only int4 scoring, a dense int4
   answer, an all-rows-kept int4 pool held against K5 on the dense int4
   cache (``allkept_attention_int4``), prune(0.3, "pair"), three queries
   on the int4 pool and the full int4 pool baseline. Counters zeroed
   before and read after; K2 and K5-K8 (K5 in both forms) must have run.
   Then the int4 flat
   layout on the same kept rows (K11), then ``compact_path_quant`` (a copy
   of the scored int4 state compacted with ``flat_decode="off"``: K5's
   decode form at T 1, 4 held on its lengths, its launches exact on the
   three queries), then the same flat state with
   ``attn_quant="int8"`` (K11-q8) and the pool with it (K7-q8), each its
   own counted phase that must not run the other modes' or layout's
   kernels (K11 and K11-q8 once a layer of each flat forward), with the
   q8 answers' agreement with the exact ones; then K11
   against K7 and both q8 kernels against their plain versions on the
   real rows, with the relative RMS of q8 against exact attention. Then
   ``fuse_layer="on"`` on the same int4 pool state (``fused_path``, its
   own counted phase): K12 must run once a layer of every decode forward
   and no flat or q8 kernel; ms/token fused and composed, evicted and
   full, from the same run; the fused answers against the composed ones
   and their logits held to the composed path's own schedule noise.
   Then the v1 W4A8 storage (``v1_path_quant``, counted): the unfused v1
   tree the flagship draws before its repack, passed as it is
   (``weight_quant="none"``, int4 KV, int8 embedding and head), through
   the same main path; K15 must run (seven launches a layer of a decode
   forward) with K2 and K5-K7, and neither K8, K12, K16 nor a flat or q8
   kernel. Its decode and teacher-forced logits against the flagship's
   composed v2 engine on the flagship's pool state (``v1_vs_v2``, held to
   twice the v2 path's schedule noise). Then ``embed_quant="int4h"`` on the
   same v1 layers (``int4h_head``, counted): K8 on the int4 lm_head
   (OUT = 152,064) and K15 on the layers, three queries on the same pool
   state, the int4 head's logits against the int8 head's on the same hidden
   states held to the reference's bound (error below 0.2 of the largest
   logit, argmax kept at clear top-2 margins), and K8 held against its
   plain version on the head's weights at every row count the phase sends
   it. Then batched serving on four int4 pools of the same four contexts
   (``serving_quant``: K7 once a layer a merged forward, K8 four times at
   T = 4 rows on each step; ``serving_quant_q8`` with
   ``attn_quant="int8"``: K7-q8 and no K7, held against the single-state
   q8 step on the same states). After the qwen2.5-7b engines
   are freed, ``checkpoint_load``: a small qwen2 checkpoint (bf16, two
   shards) and its W8A8 export written by ``write_safetensors`` (the card
   has no ``safetensors``), loaded by ``Engine(<dir>)`` through the port's
   own reader (the bf16 one stream-quantized with ``weight_quant="w4a8"``),
   each tree equal to the one written, each answering one query.
6. W8A8-KV4 path (QServe's W8A8-KV4 geometry, the upstream KVzip's own
   quantized model) at the full width of llama3.1-8b (32 layers, G = 4,
   random weights from a seed), after the qwen2.5-7b engines are freed:
   K9, K13 and K14 parity and times at its shapes, then
   ``Engine(weight_quant="w8a8", kv_quant="int4", act_fused="pallas")``
   through the same main path (its own 16384-token context and queries);
   K2, K5 (both forms), K6, K7, K13 and K14 must have run; K13's and
   K14's launches are logged by T (``w8a8_launches_by_T``). Then the
   windowed pass: one
   prefill of the same context scored exactly and with
   ``scoring_attend="window"`` (K9 must have run), reporting both scoring
   times, the Pearson correlation of the two scores and the agreement of
   their keep masks at ratio 0.3 (reported, asserted only finite).
   Every decode ms/token (``decode_ms_per_token``) is three numbers from
   the same state and queries: the engine's ``generate_ids``, whose decode
   step is captured once a state as a CUDA graph and replayed, the host
   reading the answer every ``DECODE_CHUNK`` steps (``ms_per_token``, host
   clock); that step's device time (``device_ms_per_token``, CUDA events
   around back-to-back replays); and the per-token loop of the port's first
   decode loop (``eager_ms_per_token``: ``generate_ids_per_token``, a
   forward from Python and a host read a token); the two loops' answers
   must be equal. A replay runs no Python: the engine adds its capture's
   counts once a step that advanced, to ``LAUNCHES`` and to the smoke's
   own tallies (forwards over a flat cache, K13's and K14's calls by rows,
   the serving module's merged forwards, K10/K11 calls by ``n_seq`` and
   W4A8 linears by rows),
   which sit beside it in ``ops.COUNTS``; every launch assertion above
   holds on those counts. Decode counts are thus per advanced step, not
   raw launches: replays that advance nothing (a capture's warm-up, the
   rest of a chunk after the answer ends, ``step_device_ms``'s timing
   replays) count none.
7. ``llama3.2-1b`` (16 layers, head_dim 64, which no kernel takes) at full
   width, random weights from the seed, its own 16,384-token context:
   prefill, scoring, pair 0.3 prune (a compaction: ``_use_flat`` is False
   at head_dim 64), three queries, all through the masked route; the
   phase must launch no kernel; "dense" held against "blockwise" logits.
8. The qwen3 and gemma3 families (``family_paths``), random weights
   from the seed: ``qwen3_path``, ``qwen3-8b`` at full width (36 layers,
   32 heads over 8, qk-norm) through the main path above (16,384 tokens,
   evict, pair 0.3: K1-K4 must run, every hold of the bf16 main path);
   ``serving_qwen3``, two of its 4,096-token states (pair 0.3, 0.4) merged
   as ``serving_pool`` merges four (K3 once a layer a merged forward,
   ``hold_merged``); ``gemma3_path``, ``gemma3-4b`` at full width (34
   layers, 8 heads over 4, head_dim 256, window 1,024, every sixth layer
   static, linear rope x8, vocabulary 262,208) over the hybrid ring cache
   (retain, forced): prefill and scoring seconds, static and ring bytes,
   the snapshot's copy of the rings, a second generate of a query equal
   to its first, retain 1.0 equal to the unpruned answers, pair 0.3 on
   the static layers and decode ms/token (captured / device / per-token
   loop, equal answers); the phase must launch no kernel (the masked
   route and ``attend_ring`` are torch ops); ``gemma3_window_hold``, a
   4,096-token context (four wraps of the ring): each query's last
   logits against the port's plain forward over a dense cache with the
   window mask, within twice the largest difference of three schedules of
   that forward; then pair 0.3 and the bf16 answers; K16 against its plain
   version on gemma3-4b's seven v1 linears at T 1, 2,304 and 4,096
   (``kernel_parity_k16_rows``, times beside bounds, into K16's row as
   ``gemma3_rows``); ``gemma3_v1_path``, the v1 W4A8 tree of the same
   weights (``weight_quant="none"``) on that context: K16 must launch 7 x 34
   times a forward (the phase's total a multiple of it), and nothing else;
   decode ms/token and the answers' agreement with the bf16 ones.
9. The command line (``kvzip_tpu_torch.cli.main``, in-process, in a
   temporary working directory; its output goes to stderr), each command
   a counted phase whose launches join the kernels line (``cli_launches``
   logs them): ``cli_test`` (``test -m llama3.2-3b -d squad --ratio 0.3
   --save_head_score``: K1-K4 must run; the head scores written);
   ``cli_eval`` (``eval -m llama3.2-3b -d needle --num 1``: nine ratio rows
   written; the ``--canary`` sweep parsed, 100.00 at 1.00 and never rising
   as the ratio falls; the golden compare at retain 1.0 held with
   ``retain_path``'s rule, ``golden_at_full``); ``cli_demo`` (``demo
   --ctx_tokens 16384 --baseline`` in modes ``kvzip`` and ``kvzip_head``,
   the latter on ``cli_test``'s head scores: the JSON line parses, the
   pruned cache below the dense one; K1-K3 must run); ``cli_demo_quant``
   (the same demo of qwen2.5-7b with ``--kv_quant int4 --weight_quant w4a8
   --embed_quant int8``: K2 and K5-K8 must run, no bf16 attention kernel).
10. Prints the kernels line, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the last line.
"""

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from typing import Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = "qwen2.5-7b"
CTX = 16384
NEW_TOKENS = 32
SEED = 0
# the reference's flagship configuration (its bench.py)
QUANT = dict(kv_quant="int4", weight_quant="w4a8", embed_quant="int8")
# QServe's W8A8-KV4 geometry (get_model_id("llama3-8b-4m-w8a8kv4"))
W8_MODEL = "llama3.1-8b"
W8 = dict(kv_quant="int4", weight_quant="w8a8", act_fused="pallas")
# head_dim 64: no kernel takes it, the masked route carries the model
L1_MODEL = "llama3.2-1b"
# a v1 W4A8 tree passed in as it is (every projection through K15)
V1 = dict(kv_quant="int4", weight_quant="none", embed_quant="int8")
# H100 SXM data-sheet peaks (dense bf16 and int8 tensor cores, HBM3)
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32 = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12


def log(**kw):
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of fn() over iters back-to-back calls (CUDA events): the
    device's time, or the host's where the host cannot keep up."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls captured in one CUDA graph
    and replayed: the host's launch gaps between calls are left out."""
    import torch

    fn()  # builds the kernel library and warms up outside the capture
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
    del g
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int) -> dict:
    """A kernel's device time (``graph_ms``, the kernels line's ``ms``) and
    the event time of back-to-back Python calls (``host_ms``, which also
    counts the wrapper's host work whenever that exceeds the kernel's)."""
    return dict(ms=graph_ms(fn, iters), host_ms=time_ms(fn, iters))


def rel_rms(got, want) -> float:
    """RMS(got - want) / RMS(want), in float32."""
    g, w = got.float(), want.float()
    return ((g - w).square().mean().sqrt() / w.square().mean().sqrt().clamp_min(1e-30)).item()


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def bound(flops: float, nbytes: float, peak_ops: float = PEAK_FLOPS):
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def write_safetensors(path: str, tensors: dict) -> None:
    """Write ``name -> torch tensor`` as one safetensors file: an 8-byte
    little-endian header length, a JSON header (dtype, shape and byte
    offsets of each tensor, padded with spaces to 8 bytes), then each
    tensor's little-endian bytes in name order."""
    import torch

    st = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
          torch.int8: "I8", torch.uint8: "U8", torch.int32: "I32"}
    header, blobs, off = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": st[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(blob)]}
        blobs.append(blob)
        off += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for blob in blobs:
            f.write(blob)


# library -> SASS function-name fragment of each of its wgmma kernels
WGMMA_KERNELS = {"flash": "flash_bf16_kernel", "windowed_attend": "flash_bf16_kernel",
                 "flash_int4": "flash_int4_wgmma_kernel", "score": "score_kernel"}


def hopper_build_report(_build, build_logs) -> dict:
    """ptxas's entry, register, shared-memory and spill lines for the Hopper
    kernels (K1, K2, K4, K5/K6, K9, K7/K11, K8, K12, K15/K16), and for each
    wgmma kernel the count of HGMMA instructions in its SASS and its spilled
    bytes (stores plus loads). A wgmma kernel with fewer than 16 HGMMA (one
    q.k and one p.v product of eight 16-deep steps a tile) fails the run."""
    import shutil

    rep = {}
    for name in ("flash", "ragged_decode", "flash_int4", "windowed_attend", "pool_decode_int4",
                 "flat_decode_int4", "score", "w4a8", "w4a8_v1", "w4a8_fused"):
        rep[f"{name}_ptxas"] = [ln.strip() for ln in build_logs[name].splitlines()
                                if any(w in ln for w in ("Compiling entry", "registers", "spill"))]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, frag in WGMMA_KERNELS.items():
        sass = subprocess.run([tool, "--dump-sass", _build._lib_path(name)], capture_output=True,
                              text=True, check=True).stdout
        hgmma, fn = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[1].strip()
            elif fn and frag in fn and "HGMMA" in ln:
                hgmma[fn] = hgmma.get(fn, 0) + 1
        spills, fn = {}, None
        for ln in build_logs[name].splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for")[1].strip()
            elif fn and frag in fn and "spill stores" in ln:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
                spills[fn] = int(m.group(1)) + int(m.group(2))
        rep[f"{name}_sass_hgmma"], rep[f"{name}_spill_bytes"] = hgmma, spills
        if not hgmma or min(hgmma.values()) < 16:
            raise AssertionError(f"{name}: a wgmma kernel's SASS holds fewer than 16 HGMMA: "
                                 f"{hgmma}")
    return rep


# ---------------------------------------------------------------- kernels
def hold_parity(checks, name, shape, got, want, rtol, perturbed=None):
    """Record ``ops.parity`` of got against want (and, where given, whether
    the same gate rejects a perturbed reference) under checks[name]. A q8
    reference comes as (output, slack) from its plain version's
    ``with_slack``: the gate then discounts the slack."""
    from kvzip_tpu_torch.ops import parity

    def gate(ref):
        if isinstance(ref, tuple):
            return parity(got, ref[0], rtol, ref[1])
        return parity(got, ref, rtol)

    r = dict(gate(want), shape=shape)
    if perturbed is not None:
        p = gate(perturbed)
        r.update(rejects_perturbed=not p["ok"], perturbed_rel_rms_err=p["rel_rms_err"])
    checks.setdefault(name, []).append(r)


def hold_quant(checks, name, shape, got, want):
    """Record ``ops.quant_parity`` of an int8 kernel's (q, s) against its
    plain version's, and whether the same gate rejects the plain version
    with row 0's scale doubled."""
    from kvzip_tpu_torch.ops import quant_parity

    r = dict(quant_parity(*got, *want), shape=shape)
    s2 = want[1].clone()
    s2[0] *= 2
    p = quant_parity(*got, want[0], s2)
    r.update(rejects_perturbed=not p["ok"], perturbed_scale_rel_err=p["scale_rel_err"])
    checks.setdefault(name, []).append(r)


def verify_parity(out, checks):
    """Fail on any disagreement or on a passed perturbation; fold each
    kernel's worst check into its entry of the kernels line."""
    log(phase="kernel_parity_checks", checks=checks)
    for r in out:
        rows = checks[r["name"]]
        bad = [c["shape"] for c in rows if not c["ok"]]
        if bad:
            raise AssertionError(f"{r['name']} disagrees with its plain version at {bad}")
        if not all(c.get("rejects_perturbed", True) for c in rows):
            raise AssertionError(f"{r['name']}: the gate passes a perturbed reference")
        if not any("rejects_perturbed" in c for c in rows):
            raise AssertionError(f"{r['name']}: no perturbed reference was held")
        worst = max(rows, key=lambda c: c["worst_to_tol"])
        r.update(max_abs_err=max(c["max_abs_err"] for c in rows),
                 rms_want=worst["rms_want"], worst_to_tol=worst["worst_to_tol"])
    return out


def fold_parity(row, checks):
    """Hold checks of row's kernel made after its parity phase (as
    ``verify_parity`` holds them) and fold them into its kernels-line row."""
    extra = verify_parity([dict(name=row["name"])], checks)[0]
    row["max_abs_err"] = max(row["max_abs_err"], extra["max_abs_err"])
    if extra["worst_to_tol"] > row["worst_to_tol"]:
        row.update(worst_to_tol=extra["worst_to_tol"], rms_want=extra["rms_want"])


def kernel_parity(cfg, ctx_tokens: int, sink: int, capacity: int, tail_cap: int):
    """K1-K4 against their plain versions at every shape the main path gives
    them, through ``ops.parity``. At one shape each the same gate must also
    reject a reference with a piece of the work left out (one 64-key tile,
    or K2's last 16 queries), which shows it would catch a lost split.
    Times are taken at the first shape of each kernel."""
    import torch
    import torch.nn.functional as F

    from kvzip_tpu_torch.ops import (OUT_RTOL, SCORE_RTOL, flash, pool_decode,
                                     ragged_decode, score_kernel)
    from kvzip_tpu_torch.pool import POOL_ALIGN, plan_offsets

    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // Hkv
    scale = D ** -0.5
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def sdpa(q, k, v, mask=None):
        # (T, H, D) queries against (Hkv, S, D) keys, GQA inside the call
        return F.scaled_dot_product_attention(
            q.transpose(0, 1)[None], k[None], v[None], attn_mask=mask,
            enable_gqa=True)

    cycle = iter(range(10 ** 9))

    def next_layer():
        """Cycle through the layers so each launch reads its rows from
        device memory, as a decode step does, not from the 50 MB L2."""
        return next(cycle) % L

    checks = {}

    def hold(*args, **kw):
        hold_parity(checks, *args, **kw)

    out = []
    prefill_len = sink + ctx_tokens

    # K1 at the prefill's largest chunk (4096 queries after 12288 rows) and
    # at a scoring window (2304 queries after the whole prefill), both timed
    # beside SDPA with the same causal mask
    k, v = rn(Hkv, capacity, D), rn(Hkv, capacity, D)
    kf, vf = k.float(), v.float()
    timed = {}
    for T, base in ((4096, 12288), (2304, prefill_len)):
        q = rn(T, H, D)
        lens = torch.full((Hkv,), base, dtype=torch.int32, device=dev)
        got = flash.flash_attend(q, k, v, lens, scale=scale)
        want = flash.flash_attend_plain(q.float(), kf, vf, lens, scale=scale)
        drop = None
        if T == 4096:
            drop = flash.flash_attend_plain(q.float(), kf, vf, lens - 64, scale=scale)
        hold("flash_attend", f"q ({T},{H},{D}) base {base} C {capacity}", got, want,
             OUT_RTOL, drop)
        S = base + T
        ke, ve = k[:, :S].contiguous(), v[:, :S].contiguous()
        mask = torch.arange(S, device=dev)[None] < base + torch.arange(T, device=dev)[:, None] + 1
        pairs = H * (T * base + T * (T + 1) // 2)
        b = bound(4 * D * pairs, 2 * (2 * T * H * D) + 2 * 2 * Hkv * S * D)
        timed[f"T {T} base {base}"] = dict(
            **kernel_ms(lambda: flash.flash_attend(q, k, v, lens, scale=scale), 10),
            bound_ms=b[0], bound_by=b[1], library_ms=graph_ms(lambda: sdpa(q, ke, ve, mask), 10))
        if T == 4096:
            plain_ms = time_ms(lambda: flash.flash_attend_plain(q, k, v, lens, scale=scale), 2, 1)
        del ke, ve, mask
    out.append(dict(
        name="flash_attend", route="cuda", source="kvzip_tpu_torch/csrc/flash.cu",
        replaces="kvzip_tpu/ops/flash.py:173", **timed["T 4096 base 12288"],
        plain_ms=plain_ms, per_shape=timed))
    del q, k, v, kf, vf

    # K2 at a scoring chunk: 2304 padded repeat queries, a 2048-wide window,
    # at qwen2.5-7b's heads and at llama3.1-8b's (32 over 8, the W8A8-KV4
    # path's). The bound counts the work these inputs need: one q.k of 2 D
    # operations a visible (query, key) pair, the rows of the valid queries
    # and of the keys they see read once, the scores written once;
    # exp_floor_ms the pass-1 exponentials, one a visible pair, at 16 a
    # clock an SM.
    T, s_ctx, ctx_len = 2304, 2048, 2000
    q_valid = ctx_len + 60
    K = sink + s_ctx + T
    kw = dict(sink=sink, s_ctx=s_ctx, scale=scale, model_dtype=torch.bfloat16)
    timed = {}
    for Hq, Hk in ((H, Hkv), (32, 8)):
        q, keys = rn(T, Hq, D), rn(Hk, K, D)
        got = score_kernel.fused_scores(q, keys, ctx_len, q_valid, **kw)
        want, drop = (score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len, n, **kw)
                      for n in (q_valid, q_valid - 16))
        hold("fused_scores", f"q ({T},{Hq},{D}) keys ({Hk},{K},{D})", got, want, SCORE_RTOL,
             drop)
        pairs = Hq * (q_valid * (sink + ctx_len) + q_valid * (q_valid + 1) // 2)
        b = bound(2 * D * pairs,
                  2 * (q_valid * Hq * D + Hk * (sink + ctx_len + q_valid) * D) + 4 * Hk * s_ctx)
        timed[f"H {Hq} Hkv {Hk}"] = dict(
            **kernel_ms(lambda: score_kernel.fused_scores(q, keys, ctx_len, q_valid, **kw), 10),
            bound_ms=b[0], bound_by=b[1], exp_floor_ms=pairs / (16 * sms * sm_clock_hz()) * 1e3)
        if Hq == H:
            plain_ms = time_ms(lambda: score_kernel.fused_scores_plain(
                q, keys, ctx_len, q_valid, **kw), 2, 1)
        del q, keys
    out.append(dict(
        name="fused_scores", route="cuda", source="kvzip_tpu_torch/csrc/score.cu",
        replaces="kvzip_tpu/ops/score_kernel.py:124", **timed[f"H {H} Hkv {Hkv}"],
        plain_ms=plain_ms, library_ms=None, per_shape=timed))

    # K4 at decode steps on the dense cache (T = 1; T = 4 for a query's last
    # pieces, T = 8 for the largest block): all 28 layers' stacks, cycled
    # layer by layer in timing so every launch reads its rows from device
    # memory; SDPA beside it (with the causal mask at T = 8)
    kc, vc = rn(L, Hkv, capacity, D), rn(L, Hkv, capacity, D)
    kf, vf = kc[0].float(), vc[0].float()
    lens = torch.full((Hkv,), prefill_len, dtype=torch.int32, device=dev)
    timed = {}
    for T in (1, 4, 8):
        q = rn(T, H, D)
        got = ragged_decode.ragged_decode_attend(q, kc[0], vc[0], lens, scale=scale)
        want = ragged_decode.ragged_decode_attend_plain(q.float(), kf, vf, lens, scale=scale)
        drop = None
        if T == 1:
            drop = ragged_decode.ragged_decode_attend_plain(q.float(), kf, vf, lens - 64,
                                                            scale=scale)
        hold("ragged_decode_attend", f"q ({T},{H},{D}) live {prefill_len} C {capacity}",
             got, want, OUT_RTOL, drop)
        if T == 4:
            continue
        S = prefill_len + T
        mask = None  # one query sees every live row
        if T > 1:
            mask = torch.arange(S, device=dev)[None] < (prefill_len + 1
                                                        + torch.arange(T, device=dev)[:, None])

        def k4():
            l = next_layer()
            return ragged_decode.ragged_decode_attend(q, kc[l], vc[l], lens, scale=scale)

        def k4_library():
            l = next_layer()
            return sdpa(q, kc[l, :, :S], vc[l, :, :S], mask)

        b = bound(4 * D * H * T * S, 2 * 2 * Hkv * S * D + 2 * 2 * T * H * D)
        timed[f"T {T}"] = dict(**kernel_ms(k4, 56), bound_ms=b[0], bound_by=b[1],
                               library_ms=graph_ms(k4_library, 56))
        if T == 1:
            plain_ms = time_ms(lambda: ragged_decode.ragged_decode_attend_plain(
                q, kc[0], vc[0], lens, scale=scale), 5, 1)
    out.append(dict(
        name="ragged_decode_attend", route="cuda",
        source="kvzip_tpu_torch/csrc/ragged_decode.cu",
        replaces="kvzip_tpu/ops/ragged_decode.py:125", **timed["T 1"], plain_ms=plain_ms,
        per_shape=timed))
    del kc, vc, kf, vf

    # K3 at decode steps on a pruned pool (~30% of each head's rows kept,
    # a partly filled tail): T = 1, and T = 4, 16 and 24 for a query's
    # pieces, each timed (the kernels line carries T = 1)
    rows_h = torch.randint(int(0.2 * prefill_len), int(0.4 * prefill_len), (L, Hkv),
                           generator=torch.Generator().manual_seed(SEED))
    per_layer = rows_h.sum(1).numpy()
    off, alloc, max_rows = plan_offsets(per_layer, POOL_ALIGN)
    rh = torch.full((alloc,), -1, dtype=torch.int32)
    for l in range(L):
        rh[int(off[l]):int(off[l]) + int(per_layer[l])] = torch.repeat_interleave(
            torch.arange(Hkv, dtype=torch.int32), rows_h[l])
    rh_drop = rh.clone()
    rh_drop[int(off[0]):int(off[0]) + 64] = -1
    kp, vp = rn(alloc, D), rn(alloc, D)
    kt, vt = rn(L, Hkv, tail_cap, D), rn(L, Hkv, tail_cap, D)
    pool_f = (kp.float(), vp.float())
    tail_f = (kt.float(), vt.float())
    geo = (torch.from_numpy(off).to(dev), torch.from_numpy(per_layer.astype("int32")).to(dev))
    meta, meta_drop = (rh.to(dev),) + geo, (rh_drop.to(dev),) + geo
    tail_len = 40
    live = float(per_layer.mean())
    timed = {}
    for T in (1, 4, 16, 24):
        q = rn(T, H, D)
        for l in (0, L // 2, L - 1):
            got = pool_decode.pool_decode_attend(q, kp, vp, *meta, kt, vt, tail_len, l,
                                                 scale=scale, max_rows=max_rows)
            want = pool_decode.pool_decode_attend_plain(
                q.float(), *pool_f, *meta, *tail_f, tail_len, l, scale=scale)
            drop = None
            if T == 1 and l == 0:
                drop = pool_decode.pool_decode_attend_plain(
                    q.float(), *pool_f, *meta_drop, *tail_f, tail_len, l, scale=scale)
            hold("pool_decode_attend",
                 f"q ({T},{H},{D}) layer {l} live rows {int(per_layer[l])} tail {tail_len}",
                 got, want, OUT_RTOL, drop)
        keys3 = live + Hkv * (tail_len + T)
        b = bound(4 * D * G * T * keys3, 2 * 2 * keys3 * D + 4 * live + 2 * 2 * T * H * D)
        timed[f"T {T}"] = dict(**kernel_ms(lambda: pool_decode.pool_decode_attend(
            q, kp, vp, *meta, kt, vt, tail_len, next_layer(), scale=scale,
            max_rows=max_rows), 56), bound_ms=b[0], bound_by=b[1])
        if T == 1:
            plain_ms = time_ms(lambda: pool_decode.pool_decode_attend_plain(
                q, kp, vp, *meta, kt, vt, tail_len, 0, scale=scale), 5, 1)
    out.append(dict(
        name="pool_decode_attend", route="cuda", source="kvzip_tpu_torch/csrc/pool_decode.cu",
        replaces="kvzip_tpu/ops/pool_decode.py:424", **timed["T 1"], plain_ms=plain_ms,
        library_ms=None, per_shape=timed))
    # one tail length per kv head (the merged pool of serving), one of them 0
    tails = torch.tensor([0] + [tail_len + 13 * h for h in range(1, Hkv)], dtype=torch.int32,
                         device=dev)
    for T in (1, 4):
        q = rn(T, H, D)
        for l in (0, L - 1):
            got = pool_decode.pool_decode_attend(q, kp, vp, *meta, kt, vt, tails, l,
                                                 scale=scale, max_rows=max_rows)
            want = pool_decode.pool_decode_attend_plain(
                q.float(), *pool_f, *meta, *tail_f, tails, l, scale=scale)
            hold("pool_decode_attend", f"q ({T},{H},{D}) layer {l} tails {tails.tolist()}",
                 got, want, OUT_RTOL)
    del kp, vp, kt, vt, pool_f, tail_f

    return verify_parity(out, checks)


def kernel_parity_int4(cfg, ctx_tokens: int, sink: int, capacity: int, tail_cap: int):
    """K5-K8 against their plain versions at the shapes the quantized main
    path gives them, through ``ops.parity``: K5's prefill form at a
    4096-query chunk after 12,288 int4 rows and at T = 17 (the first T past
    ``SPLIT_T``), its decode form at T = 1, 4 and 16 on the dense int4 cache
    (two rows of the kernels line, each with its own launches); K6 at a
    2304-query scoring chunk after the whole prefill, K5's prefill form and
    K6 each beside the dequantize-then-K1 yardstick (``deq_k1_ms``,
    ``k1_ms``, logged); K7 at
    T = 1/4/16 on a ~30% int4 pool, layers 0/14/27, tail 40, and over 40
    kv heads (G 1 and 7); K8 at T = 1, 4, 16, 24 and 256 for each of the
    four W4A8 linears. At one shape each the
    gate must reject a reference with one 64-key tile (K5-K7) or one
    128-row input group (K8) left out (K8 at the lm_head's shape is held in
    ``int4h_path``). Times: ``kernel_ms``; the decode-shape
    kernels cycle over the 28 layers' stacks, so each launch reads its
    rows or weights from device memory."""
    import torch

    from kvzip_tpu_torch.ops import OUT_RTOL, flash, flash_int4, pool_decode, w4a8_v2
    from kvzip_tpu_torch.ops.quant import dequantize_int4, quantize_int4
    from kvzip_tpu_torch.pool import POOL_ALIGN, plan_offsets

    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G, Dp = H // Hkv, D // 2
    scale = D ** -0.5
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cycle = iter(range(10 ** 9))

    def next_layer():
        return next(cycle) % L

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def quant(*shape):
        """Random N(0, 1) rows (..., D) quantized as the int4 caches hold
        them: packed (..., D//2) uint8, bf16 scale and zero (...)."""
        p, s_, z = quantize_int4(rn(*shape, D), pack="split")
        return p, s_[..., 0], z[..., 0]

    checks, out = {}, []

    def hold(*args, **kw):
        hold_parity(checks, *args, **kw)

    prefill_len = sink + ctx_tokens
    row_bytes = Dp + 4          # packed row + bf16 scale and zero

    # K5: dense int4 cache of every layer (decode cycles over them); the
    # prefill form (T > 16) and the decode form are two rows of the line
    layers = [(*quant(Hkv, capacity), *quant(Hkv, capacity)) for _ in range(L)]
    kv0 = layers[0]

    def deq(p, s_, z):
        return dequantize_int4(p, s_[..., None], z[..., None], torch.bfloat16, pack="split")

    def yardstick(q, lens, live_rows):
        """The same attention computed by dequantizing the live rows to bf16
        and calling K1: the composition's time and K1's alone on the
        dequantized rows (notes beside the kernel, never a route of the
        port)."""
        kd, vd = live_rows()
        return dict(deq_k1_ms=graph_ms(lambda: flash.flash_attend(q, *live_rows(), lens,
                                                                  scale=scale), 10),
                    k1_ms=graph_ms(lambda: flash.flash_attend(q, kd, vd, lens, scale=scale), 10))

    decode_timed = {}
    for T, base in ((4096, 12288), (17, 700), (1, prefill_len), (4, prefill_len),
                    (16, prefill_len)):
        q = rn(T, H, D)
        lens = torch.full((Hkv,), base, dtype=torch.int32, device=dev)
        name = "flash_attend_int4" if T > flash_int4.SPLIT_T else "flash_attend_int4_decode"
        got = flash_int4.flash_attend_int4(q, *kv0, lens, scale=scale)
        want = flash_int4.flash_attend_int4_plain(q.float(), *kv0, lens, scale=scale)
        drop = None
        if T in (4096, 1):
            drop = flash_int4.flash_attend_int4_plain(q.float(), *kv0, lens - 64, scale=scale)
        hold(name, f"q ({T},{H},{D}) base {base} C {capacity}", got, want, OUT_RTOL, drop)
        if T == 4096:
            S = base + T
            pairs = H * (T * base + T * (T + 1) // 2)
            b = bound(4 * D * pairs,
                      2 * 2 * T * H * D + 2 * Hkv * (base + T) * row_bytes)
            out.append(dict(
                name="flash_attend_int4", route="cuda",
                source="kvzip_tpu_torch/csrc/flash_int4.cu",
                replaces="kvzip_tpu/ops/flash_int4.py:354",
                **kernel_ms(lambda: flash_int4.flash_attend_int4(q, *kv0, lens, scale=scale),
                            10),
                plain_ms=time_ms(lambda: flash_int4.flash_attend_int4_plain(
                    q, *kv0, lens, scale=scale), 2, 1),
                bound_ms=b[0], bound_by=b[1], library_ms=None,
                **yardstick(q, lens, lambda: (deq(*(a[:, :S] for a in kv0[:3])),
                                              deq(*(a[:, :S] for a in kv0[3:]))))))
        elif T <= flash_int4.SPLIT_T:
            S = base + T
            pairs = H * (T * base + T * (T + 1) // 2)
            b = bound(4 * D * pairs, 2 * Hkv * S * row_bytes + 2 * 2 * T * H * D)
            decode_timed[f"T {T}"] = dict(
                **kernel_ms(lambda: flash_int4.flash_attend_int4(
                    q, *layers[next_layer()], lens, scale=scale), 56),
                bound_ms=b[0], bound_by=b[1])
            if T == 1:
                decode_plain_ms = time_ms(lambda: flash_int4.flash_attend_int4_plain(
                    q, *kv0, lens, scale=scale), 5, 1)
    out.append(dict(
        name="flash_attend_int4_decode", route="cuda",
        source="kvzip_tpu_torch/csrc/flash_int4.cu",
        replaces="kvzip_tpu/ops/flash_int4.py:354", **decode_timed["T 1"],
        plain_ms=decode_plain_ms, library_ms=None, per_shape=decode_timed))

    # K6: a scoring chunk of 2304 padded queries after the whole prefill
    T = 2304
    q = rn(T, H, D)
    extra = (*quant(T, Hkv), *quant(T, Hkv))
    lens = torch.full((Hkv,), prefill_len, dtype=torch.int32, device=dev)
    got = flash_int4.flash_attend_int4_extra(q, *kv0, lens, *extra, scale=scale)
    want, drop = (flash_int4.flash_attend_int4_extra_plain(q.float(), *kv0, n, *extra,
                                                           scale=scale)
                  for n in (lens, lens - 64))
    hold("flash_attend_int4_extra", f"q ({T},{H},{D}) base {prefill_len}", got, want,
         OUT_RTOL, drop)
    pairs = H * (T * prefill_len + T * (T + 1) // 2)
    b = bound(4 * D * pairs, 2 * 2 * T * H * D + 2 * Hkv * (prefill_len + T) * row_bytes)
    out.append(dict(
        name="flash_attend_int4_extra", route="cuda",
        source="kvzip_tpu_torch/csrc/flash_int4.cu",
        replaces="kvzip_tpu/ops/flash_int4.py:460",
        **kernel_ms(lambda: flash_int4.flash_attend_int4_extra(q, *kv0, lens, *extra,
                                                               scale=scale), 10),
        plain_ms=time_ms(lambda: flash_int4.flash_attend_int4_extra_plain(
            q, *kv0, lens, *extra, scale=scale), 2, 1),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        **yardstick(q, lens, lambda: tuple(
            torch.cat([deq(*(a[:, :prefill_len] for a in kv0[i:i + 3])),
                       deq(*extra[i:i + 3]).transpose(0, 1)], dim=1) for i in (0, 3)))))
    del layers, kv0, extra

    # K7: a pruned int4 pool (~30% of each head's rows), partly filled tail
    rows_h = torch.randint(int(0.2 * prefill_len), int(0.4 * prefill_len), (L, Hkv),
                           generator=torch.Generator().manual_seed(SEED + 2))
    per_layer = rows_h.sum(1).numpy()
    off, alloc, max_rows = plan_offsets(per_layer, POOL_ALIGN)
    rh = torch.full((alloc,), -1, dtype=torch.int32)
    for l in range(L):
        rh[int(off[l]):int(off[l]) + int(per_layer[l])] = torch.repeat_interleave(
            torch.arange(Hkv, dtype=torch.int32), rows_h[l])
    rh_drop = rh.clone()
    rh_drop[int(off[0]):int(off[0]) + 64] = -1
    kq, ks, kz = quant(alloc)
    vq, vs, vz = quant(alloc)
    pool = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())
    kt, vt = rn(L, Hkv, tail_cap, D), rn(L, Hkv, tail_cap, D)
    geo = (torch.from_numpy(off).to(dev), torch.from_numpy(per_layer.astype("int32")).to(dev))
    meta, meta_drop = (rh.to(dev),) + geo, (rh_drop.to(dev),) + geo
    tail_len = 40
    live = float(per_layer.mean())
    for T in (1, 4, 16):
        q = rn(T, H, D)
        for l in (0, L // 2, L - 1):
            got = pool_decode.pool_decode_attend_int4(q, *pool, *meta, kt, vt, tail_len, l,
                                                      scale=scale, max_rows=max_rows)
            want = pool_decode.pool_decode_attend_int4_plain(
                q.float(), *pool, *meta, kt.float(), vt.float(), tail_len, l, scale=scale)
            drop = None
            if T == 1 and l == 0:
                drop = pool_decode.pool_decode_attend_int4_plain(
                    q.float(), *pool, *meta_drop, kt.float(), vt.float(), tail_len, l,
                    scale=scale)
            hold("pool_decode_attend_int4",
                 f"q ({T},{H},{D}) layer {l} live rows {int(per_layer[l])} tail {tail_len}",
                 got, want, OUT_RTOL, drop)
        if T != 1:
            continue
        keys = live + Hkv * (tail_len + T)
        b = bound(4 * D * G * T * keys,
                  2 * live * (Dp + 8) + 4 * live + 2 * 2 * Hkv * (tail_len + T) * D
                  + 2 * 2 * T * H * D)
        out.append(dict(
            name="pool_decode_attend_int4", route="cuda",
            source="kvzip_tpu_torch/csrc/pool_decode_int4.cu",
            replaces="kvzip_tpu/ops/pool_decode.py:340",
            **kernel_ms(lambda: pool_decode.pool_decode_attend_int4(
                q, *pool, *meta, kt, vt, tail_len, next_layer(), scale=scale,
                max_rows=max_rows), 56),
            plain_ms=time_ms(lambda: pool_decode.pool_decode_attend_int4_plain(
                q, *pool, *meta, kt, vt, tail_len, 0, scale=scale), 5, 1),
            bound_ms=b[0], bound_by=b[1], library_ms=None))

    # K7-q8 at the same shapes: held against the plain q8 version at the
    # kernel's 64-row p tile; the relative RMS of q8 against exact logged
    q8_cost = []
    for T in (1, 4, 16):
        q = rn(T, H, D)
        for l in (0, L // 2, L - 1):
            got = pool_decode.pool_decode_attend_int4(q, *pool, *meta, kt, vt, tail_len, l,
                                                      scale=scale, max_rows=max_rows, q8=True)
            want = pool_decode.pool_decode_attend_int4_plain(
                q.float(), *pool, *meta, kt.float(), vt.float(), tail_len, l, scale=scale,
                q8=True, with_slack=True)
            drop = None
            if T == 1 and l == 0:
                drop = pool_decode.pool_decode_attend_int4_plain(
                    q.float(), *pool, *meta_drop, kt.float(), vt.float(), tail_len, l,
                    scale=scale, q8=True, with_slack=True)
            hold("pool_decode_attend_int4_q8",
                 f"q ({T},{H},{D}) layer {l} live rows {int(per_layer[l])} tail {tail_len}",
                 got, want, OUT_RTOL, drop)
            exact = pool_decode.pool_decode_attend_int4(q, *pool, *meta, kt, vt, tail_len, l,
                                                        scale=scale, max_rows=max_rows)
            q8_cost.append(rel_rms(got, exact))
        if T != 1:
            continue
        keys = live + Hkv * (tail_len + T)
        b = bound(4 * D * G * T * keys,
                  2 * live * (Dp + 8) + 4 * live + 2 * 2 * Hkv * (tail_len + T) * D
                  + 2 * 2 * T * H * D, PEAK_INT8_OPS)
        out.append(dict(
            name="pool_decode_attend_int4_q8", route="cuda",
            source="kvzip_tpu_torch/csrc/pool_decode_int4.cu",
            replaces="kvzip_tpu/ops/pool_decode.py:340",
            **kernel_ms(lambda: pool_decode.pool_decode_attend_int4(
                q, *pool, *meta, kt, vt, tail_len, next_layer(), scale=scale,
                max_rows=max_rows, q8=True), 56),
            plain_ms=time_ms(lambda: pool_decode.pool_decode_attend_int4_plain(
                q, *pool, *meta, kt, vt, tail_len, 0, scale=scale, q8=True), 5, 1),
            bound_ms=b[0], bound_by=b[1], library_ms=None))
    log(phase="k7_q8_vs_exact", rel_rms=q8_cost)
    # K7 and K7-q8 with one tail length per kv head (the merged pool of
    # serving), one of them 0
    tails = torch.tensor([0] + [tail_len + 13 * h for h in range(1, Hkv)], dtype=torch.int32,
                         device=dev)
    for T in (1, 4):
        q = rn(T, H, D)
        for l in (0, L - 1):
            for q8, name in ((False, "pool_decode_attend_int4"),
                             (True, "pool_decode_attend_int4_q8")):
                got = pool_decode.pool_decode_attend_int4(q, *pool, *meta, kt, vt, tails, l,
                                                          scale=scale, max_rows=max_rows,
                                                          q8=q8)
                want = pool_decode.pool_decode_attend_int4_plain(
                    q.float(), *pool, *meta, kt.float(), vt.float(), tails, l, scale=scale,
                    q8=q8, **(dict(with_slack=True) if q8 else {}))
                hold(name, f"q ({T},{H},{D}) layer {l} tails {tails.tolist()}", got, want,
                     OUT_RTOL)
    del pool, kq, vq, kt, vt

    # K7 and K7-q8 over 40 kv heads (a merged pool of ten qwen2.5-7b
    # sequences, G 7, and the G 1 case where a row group spans more than 32
    # kv heads), 1,500 rows a head in a shuffled order, one tail length a
    # kv head (one of them 0)
    Hm, n40 = 40, 40 * 1500
    rh40 = torch.randint(0, Hm, (n40,), dtype=torch.int32, device=dev, generator=gen)
    rh40_drop = rh40.clone()
    rh40_drop[:64] = -1
    kq, ks, kz = quant(n40)
    vq, vs, vz = quant(n40)
    pool = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())
    kt, vt = rn(1, Hm, tail_cap, D), rn(1, Hm, tail_cap, D)
    geo = (torch.zeros(1, dtype=torch.int32, device=dev),
           torch.full((1,), n40, dtype=torch.int32, device=dev))
    tails = torch.tensor([(37 * h) % 300 for h in range(Hm)], dtype=torch.int32, device=dev)
    for Gm in (1, G):
        q = rn(1, Hm * Gm, D)
        for q8, name in ((False, "pool_decode_attend_int4"), (True, "pool_decode_attend_int4_q8")):
            got = pool_decode.pool_decode_attend_int4(q, *pool, rh40, *geo, kt, vt, tails, 0,
                                                      scale=scale, max_rows=n40, q8=q8)
            want, drop = (pool_decode.pool_decode_attend_int4_plain(
                q.float(), *pool, r, *geo, kt.float(), vt.float(), tails, 0, scale=scale,
                q8=q8, **(dict(with_slack=True) if q8 else {})) for r in (rh40, rh40_drop))
            hold(name, f"q (1,{Hm * Gm},{D}) {Hm} kv heads, {n40} rows shuffled, tails",
                 got, want, OUT_RTOL, drop)
    del pool, kq, vq, kt, vt, rh40, rh40_drop

    # K8: the four W4A8 linears of qwen2.5-7b as 28-layer v2 stacks with
    # random bytes and scales (the kernel's work does not depend on them)
    D_m, I = cfg.hidden_size, cfg.intermediate_size
    linears = dict(wqkv=(D_m, (H + 2 * Hkv) * D), wo=(H * D, D_m), w_gateup=(D_m, 2 * I),
                   w_down=(I, D_m))
    timed = {}
    for name, (IN, OUT) in linears.items():
        half, Gp8 = OUT // 2, -(-IN // 128 // 8) * 8
        w = dict(q4=torch.randint(0, 256, (L, IN, half), dtype=torch.uint8, device=dev,
                                  generator=gen),
                 s2=(torch.rand(L, 2, Gp8, half, device=dev, generator=gen) * 0.002
                     ).to(torch.bfloat16),
                 z2=(-0.03 + 0.002 * torch.randn(L, 2, Gp8, half, device=dev,
                                                 generator=gen)).to(torch.bfloat16))
        for T in (1, 4, 16, 24, 256):
            x = rn(T, IN)
            got = w4a8_v2.w4a8_matmul_stacked_v2(x, w["q4"], w["s2"], w["z2"], 0)
            w0 = {k: v[0] for k, v in w.items()}
            want = w4a8_v2.w4a8_jnp_v2(x.float(), w0)
            drop = None
            if T == 1:
                xd = x.float().clone()
                xd[:, :128] = 0
                drop = w4a8_v2.w4a8_jnp_v2(xd, w0)
            hold("w4a8_matmul_stacked_v2", f"{name} {IN}->{OUT} T {T}", got, want,
                 OUT_RTOL, drop)
            nbytes = IN * half + 2 * 2 * 2 * Gp8 * half + 2 * T * IN + 2 * T * OUT
            b = bound(2 * T * IN * OUT, nbytes, PEAK_INT8_OPS)
            timed[(name, T)] = dict(
                **kernel_ms(lambda: w4a8_v2.w4a8_matmul_stacked_v2(
                    x, w["q4"], w["s2"], w["z2"], next_layer()), 56 if T <= 24 else 10),
                bound_ms=b[0], bound_by=b[1])
            if T == 1:
                timed[(name, T)]["plain_ms"] = time_ms(lambda: w4a8_v2.w4a8_jnp_v2(x, w0),
                                                       2, 1)
        del w
    # the kernels line carries one decode step's four linears at T = 1, summed
    step = [timed[(n, 1)] for n in linears]
    out.append(dict(
        name="w4a8_matmul_stacked_v2", route="cuda", source="kvzip_tpu_torch/csrc/w4a8.cu",
        replaces="kvzip_tpu/ops/w4a8_v2.py:257",
        **{k: sum(t[k] for t in step) for k in ("ms", "host_ms", "plain_ms", "bound_ms")},
        bound_by="bytes" if all(t["bound_by"] == "bytes" for t in step) else "operations",
        library_ms=None, per_shape={f"{n} T {t}": v for (n, t), v in timed.items()}))
    return verify_parity(out, checks)


def v1_stack(L, IN, OUT, gen):
    """A v1 W4A8 stack as ``quantize_weight_int4`` stores it: random bytes
    in the true input rows, 0x00 in the pad rows (IN rounded up to a
    multiple of 16 groups of 128), per-(group, column) bf16 scales with
    zeros centring each group's nibbles (weights of standard deviation
    ~0.02), s = z = 0 on the pad groups."""
    import torch

    G = IN // 128
    Gp = -(-G // min(16, G)) * min(16, G)
    q4 = torch.randint(0, 256, (L, Gp * 128, OUT // 2), dtype=torch.uint8, device="cuda",
                       generator=gen)
    q4[:, IN:] = 0
    s = 0.0043 * (0.75 + 0.5 * torch.rand(L, Gp, OUT, device="cuda", generator=gen))
    s[:, G:] = 0
    return dict(q4=q4, s=s.to(torch.bfloat16), z=(-7.5 * s).to(torch.bfloat16))


def kernel_parity_w4a8_v1(cfg):
    """K15 (``w4a8_matmul_stacked``) and K16 (``w4a8_matmul``) against
    their plain version (``_w4a8_jnp``) at qwen2.5-7b's unfused v1 shapes
    (q/k/v 3584 -> 3584, 512, 512; o 3584 -> 3584; gate/up 3584 -> 18944;
    down 18944 -> 3584, its 148 groups stored as 160) and the fused v1 ones
    (qkv 3584 -> 4608, gate/up 3584 -> 37888), as 28-layer stacks: K15 at
    T 1, 24 and 511 and layers 0, 14 and 27; K16 on layer slices at T 1 and
    24, with a bias on q/k/v. The gate must reject a reference with one
    input group dropped (one shape each). Times: ``kernel_ms`` at T 1
    cycling over the 28 layers, so that each launch reads its weights from
    device memory, and at T 24 and 511 (K16 at T 1 and 24); the kernels
    line carries one decode step's seven unfused linears at T 1, summed.
    Bound: the weight bytes the product needs (true groups only) plus x and
    out over 3.35 TB/s, against 2 T IN OUT int8 operations;
    ``padded_bound_ms`` counts the pad groups' bytes too."""
    import torch

    from kvzip_tpu_torch.ops import OUT_RTOL, w4a8

    L, H, Hkv, Dh = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    D, I = cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shapes = dict(wq=(D, H * Dh), wk=(D, Hkv * Dh), wv=(D, Hkv * Dh), wo=(H * Dh, D),
                  w_gate=(D, I), w_up=(D, I), w_down=(I, D),
                  wqkv=(D, (H + 2 * Hkv) * Dh), w_gateup=(D, 2 * I))
    biased = ("wq", "wk", "wv", "wqkv")
    checks, timed = {}, {}
    cycle = iter(range(10 ** 9))

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def k16_plain(xf, wl, bias):
        """The plain version, the bias added to its bf16 output."""
        y = w4a8._w4a8_jnp(xf, wl)
        return y if bias is None else y.to(torch.bfloat16).float() + bias.float()

    for name, (IN, OUT) in shapes.items():
        w = v1_stack(L, IN, OUT, gen)
        G, Gp = IN // 128, w["s"].shape[1]
        bias = rn(OUT) * 0.1 if name in biased else None
        for T in (1, 24, 511):
            x = rn(T, IN)
            for l in (0, L // 2, L - 1):
                wl = {k: v[l] for k, v in w.items()}
                got = w4a8.w4a8_matmul_stacked(x, w["q4"], w["s"], w["z"], l)
                want = w4a8._w4a8_jnp(x.float(), wl)
                drop = None
                if T == 1 and l == 0:
                    xd = x.float().clone()
                    xd[:, 128:256] = 0
                    drop = w4a8._w4a8_jnp(xd, wl)
                hold_parity(checks, "w4a8_matmul_stacked", f"{name} {IN}->{OUT} T {T} layer {l}",
                            got, want, OUT_RTOL, drop)
                if T == 511 or l != 0:
                    continue
                got = w4a8.w4a8_matmul(x, wl["q4"], wl["s"], wl["z"], bias)
                want = k16_plain(x.float(), wl, bias)
                drop = None
                if T == 1:
                    xd = x.float().clone()
                    xd[:, :128] = 0
                    drop = k16_plain(xd, wl, bias)
                hold_parity(checks, "w4a8_matmul", f"{name} {IN}->{OUT} T {T} bias "
                            f"{bias is not None}", got, want, OUT_RTOL, drop)
            half = OUT // 2
            io = 2 * T * IN + 2 * T * OUT
            b = bound(2 * T * IN * OUT, IN * half + 2 * 2 * G * OUT + io, PEAK_INT8_OPS)
            padded = bound(2 * T * IN * OUT, Gp * 128 * half + 2 * 2 * Gp * OUT + io,
                           PEAK_INT8_OPS)
            iters = 56 if T == 1 else 10
            r = dict(**kernel_ms(lambda: w4a8.w4a8_matmul_stacked(
                x, w["q4"], w["s"], w["z"], next(cycle) % L), iters),
                bound_ms=b[0], bound_by=b[1], padded_bound_ms=padded[0])
            if T == 1:
                r["plain_ms"] = time_ms(lambda: w4a8._w4a8_jnp(x, {k: v[0] for k, v in w.items()}),
                                        2, 1)
            if T < 511:
                slices = [{k: v[l] for k, v in w.items()} for l in range(L)]
                r16 = kernel_ms(lambda: w4a8.w4a8_matmul(
                    x, *(slices[next(cycle) % L][k] for k in ("q4", "s", "z")), bias), iters)
                r.update(k16_ms=r16["ms"], k16_host_ms=r16["host_ms"])
            timed[(name, T)] = r
        del w
    log(phase="k15_k16_times", **{f"{n} T {t}": v for (n, t), v in timed.items()})
    step = [timed[(n, 1)] for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    per_shape = {f"{n} T {t}": v for (n, t), v in timed.items()}
    common = dict(route="cuda", source="kvzip_tpu_torch/csrc/w4a8_v1.cu", library_ms=None,
                  bound_ms=sum(t["bound_ms"] for t in step),
                  bound_by="bytes" if all(t["bound_by"] == "bytes" for t in step) else "operations",
                  padded_bound_ms=sum(t["padded_bound_ms"] for t in step),
                  plain_ms=sum(t["plain_ms"] for t in step))
    out = [dict(name="w4a8_matmul_stacked", replaces="kvzip_tpu/ops/w4a8.py:346",
                ms=sum(t["ms"] for t in step), host_ms=sum(t["host_ms"] for t in step),
                per_shape=per_shape, **common),
           dict(name="w4a8_matmul", replaces="kvzip_tpu/ops/w4a8.py:169",
                ms=sum(t["k16_ms"] for t in step), host_ms=sum(t["k16_host_ms"] for t in step),
                **common)]
    return verify_parity(out, checks)


def fused_stacks(cfg, gen):
    """qwen2.5-7b's four W4A8 linears as 28-layer v2 stacks: random bytes
    and per-(group, column) scales with zeros centring each group's nibbles
    (weights of standard deviation ~0.02, as a trained layer's), stored
    pre-folded as the v2 layout keeps them."""
    import torch

    L, H, Hkv, Dh = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    D, I = cfg.hidden_size, cfg.intermediate_size
    dev = "cuda"
    stacks = []
    for IN, OUT in ((H * Dh, D), (D, 2 * I), (I, D), (D, (H + 2 * Hkv) * Dh)):
        half, Gp8 = OUT // 2, -(-IN // 128 // 8) * 8
        s = 0.0043 * (0.75 + 0.5 * torch.rand(L, 2, Gp8, half, device=dev, generator=gen))
        z = -7.5 * s
        s[:, 0] /= 16.0                 # the high half pre-folded: s_hi / 16,
        z[:, 0] += 8.0 * 16.0 * s[:, 0]  # z_hi + 8 s_hi
        stacks.append(dict(
            q4=torch.randint(0, 256, (L, IN, half), dtype=torch.uint8, device=dev,
                             generator=gen),
            s2=s.to(torch.bfloat16), z2=z.to(torch.bfloat16)))
    return stacks


def kernel_parity_fused(cfg):
    """K12 (the fused W4A8 decode layer) against its plain version at
    qwen2.5-7b's shapes (D 3584, I 18944, H*Dh 3584, qkv 4608, 28 layers),
    T 1, 4 and 8 at layers 0, 14 and 27, with the next layer's qkv weights
    as the forward passes them, through ``ops.parity`` on both outputs; the
    gate must reject a reference whose qkv weights lack one input group and
    one whose o-proj lacks a 128-column block. Times at T 1, cycling over
    the 28 layers: K12, its plain version, and the composed chain it
    replaces (four K8 calls, two RMSNorms, SiLU*up and the residual adds),
    each as device time (``graph_ms``; the capture takes K12's cooperative
    launch), and both at T 4 and 8."""
    import torch
    import torch.nn.functional as F

    from kvzip_tpu_torch.models.transformer import rms_norm
    from kvzip_tpu_torch.ops import OUT_RTOL, w4a8_fused
    from kvzip_tpu_torch.ops.w4a8 import w4a8_linear_stacked

    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    HD = cfg.num_heads * cfg.head_dim
    eps = cfg.rms_norm_eps
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ws = fused_stacks(cfg, gen)
    w_o, w_gu, w_dn, w_qkv = ws

    def rn(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen, device=dev)).to(torch.bfloat16)

    lnm, lna = 1 + rn(L, D, std=0.1), 1 + rn(L, D, std=0.1)
    checks, out = {}, []
    cycle = iter(range(10 ** 9))

    def fused(x, attn, l):
        return w4a8_fused.w4a8_layer_fused(x, attn, lnm, lna, *ws, l, eps=eps,
                                           qkv_layer=min(l + 1, L - 1))

    def plain(x, attn, l, weights=ws):
        return w4a8_fused.w4a8_layer_fused_plain(x, attn, lnm, lna, *weights, l, eps=eps,
                                                 qkv_layer=min(l + 1, L - 1))

    for T in (1, 4, 8):
        x, attn = rn(T, D, std=0.5), rn(T, HD, std=0.3)
        for l in (0, L // 2, L - 1):
            got, want = fused(x, attn, l), plain(x, attn, l)
            drops = (None, None)
            if T == 1 and l == 0:
                qkv_d, o_d = ({k: v.clone() for k, v in w.items()} for w in (w_qkv, w_o))
                for k in ("s2", "z2"):
                    qkv_d[k][1, :, D // 256] = 0  # the middle input group of layer 1's qkv
                    o_d[k][0, 0, :, :128] = 0    # o-proj output columns 0..127
                drops = (plain(x, attn, l, (o_d, w_gu, w_dn, w_qkv))[0],
                         plain(x, attn, l, (w_o, w_gu, w_dn, qkv_d))[1])
            for g, w, d, what in zip(got, want, drops, ("x_new", "qkv")):
                if not torch.isfinite(g.float()).all():
                    raise AssertionError(f"w4a8_layer_fused: non-finite {what}")
                hold_parity(checks, "w4a8_layer_fused", f"{what} T {T} layer {l}", g, w,
                            OUT_RTOL, d)
    def composed(x, attn, l):
        o = w4a8_linear_stacked(attn, w_o, l)
        x1 = x + o
        gate, up = w4a8_linear_stacked(rms_norm(x1, lnm[l], eps), w_gu, l).chunk(2, dim=-1)
        x2 = x1 + w4a8_linear_stacked(F.silu(gate) * up, w_dn, l)
        nxt = min(l + 1, L - 1)
        return x2, w4a8_linear_stacked(rms_norm(x2, lna[nxt], eps), w_qkv, nxt)

    per_shape = {}
    for T in (8, 4, 1):  # T 1 last: its x and attn stay for the kernels line
        x, attn = rn(T, D, std=0.5), rn(T, HD, std=0.3)
        per_shape[f"T {T}"] = dict(
            ms=graph_ms(lambda: fused(x, attn, next(cycle) % L), 56),
            composed_ms=graph_ms(lambda: composed(x, attn, next(cycle) % L), 56))

    t = kernel_ms(lambda: fused(x, attn, next(cycle) % L), 56)
    chain = kernel_ms(lambda: composed(x, attn, next(cycle) % L), 56)
    # bytes the layer must move: its four weight slices and their scales,
    # x, attn and the two norm rows read, x_new and qkv written
    nbytes = sum(w["q4"][0].numel() + 2 * 2 * w["s2"][0].numel() for w in ws) \
        + 2 * (D + HD + 2 * D + D + w_qkv["q4"].shape[2] * 2)
    ops = 2 * sum(w["q4"].shape[1] * w["q4"].shape[2] * 2 for w in ws)
    b = bound(ops, nbytes, PEAK_INT8_OPS)
    out.append(dict(
        name="w4a8_layer_fused", route="cuda", source="kvzip_tpu_torch/csrc/w4a8_fused.cu",
        replaces="kvzip_tpu/ops/w4a8_fused.py:330", **t,
        plain_ms=time_ms(lambda: plain(x, attn, 0), 3, 1),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        composed_ms=chain["ms"], composed_host_ms=chain["host_ms"], weight_bytes=nbytes,
        per_shape=per_shape, composed_per_shape=per_shape))
    log(phase="k12_times", **{k: out[-1][k] for k in (
        "ms", "host_ms", "plain_ms", "bound_ms", "composed_ms", "composed_host_ms",
        "weight_bytes", "per_shape")})
    del ws, w_o, w_gu, w_dn, w_qkv
    return verify_parity(out, checks)


def kernel_parity_flat(cfg, ctx_tokens: int, sink: int, tail_cap: int):
    """K10, K11 and K11-q8 against their plain versions at the shapes the
    legacy flat layout gives them at qwen2.5-7b: T = 1 (a decode step) and
    24 (a whole query, 168 query rows a kv head), n_seq = 1 and 2 (two
    sequences merged, one tail length per (sequence, kv head)), on an
    evicted flat stack (~30% of each head's rows kept, every layer padded
    to the engine's r_pad for the largest layer) and on the full one (every
    row kept, 98,304 rows a layer at 16k), each kernel given the stack's
    live rows a segment (``seg_rows``). The q8 holds discount two p steps
    a row (``hold_parity``). At T = 1, n_seq = 1 on the evicted stack the
    gate must reject a reference with the layer's first 64-row tile dropped.
    Times: the kernels line carries T = 1, n_seq = 1, evicted; every shape's
    time is logged. Timed launches cycle over the stack's layers (28 for
    n_seq = 1, 4 for n_seq = 2), so each reads its rows from device memory.
    Bound: the live rows, the tail, q and out over 3.35 TB/s (and, beside
    it, ``padded_bound_ms``: every row of R_pad read, as a kernel without
    ``seg_rows`` reads them)."""
    import torch

    from kvzip_tpu_torch.engine import _round_flat_rows
    from kvzip_tpu_torch.ops import OUT_RTOL, flat_decode
    from kvzip_tpu_torch.ops.quant import quantize_int4

    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G, Dp = H // Hkv, D // 2
    scale = D ** -0.5
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    prefill_len = sink + ctx_tokens
    tail_len = 40

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def stack(n_layers, n_seq, full):
        """row_head of a flat stack, r_pad, the mean live rows a (layer,
        seq) and the live rows of each (``seg_rows``, (layers, n_seq))."""
        if full:
            rows_h = torch.full((n_layers, n_seq, Hkv), prefill_len, dtype=torch.int64)
        else:
            rows_h = torch.randint(int(0.2 * prefill_len), int(0.4 * prefill_len),
                                   (n_layers, n_seq, Hkv),
                                   generator=torch.Generator().manual_seed(SEED + 4))
        r_pad = _round_flat_rows(int(rows_h.sum(-1).max()))
        rh = torch.full((n_layers, n_seq * r_pad), -1, dtype=torch.int32)
        for l in range(n_layers):
            for sb in range(n_seq):
                ids = torch.repeat_interleave(torch.arange(Hkv, dtype=torch.int32) + sb * Hkv,
                                              rows_h[l, sb])
                rh[l, sb * r_pad:sb * r_pad + len(ids)] = ids
        return (rh.to(dev), r_pad, float(rows_h.sum(-1).float().mean()),
                rows_h.sum(-1).to(torch.int32).to(dev))

    def quant(*shape):
        p, s_, z = quantize_int4(rn(*shape, D), pack="split")
        return p, s_[..., 0].float(), z[..., 0].float()

    checks, timed = {}, {}
    modes = (("flat_decode_attend", "bf16"), ("flat_decode_attend_int4", "int4"),
             ("flat_decode_attend_int4_q8", "q8"))
    for full in (False, True):
        for n_seq in (1, 2):
            n_layers = L if n_seq == 1 else 4
            rh, r_pad, live, seg = stack(n_layers, n_seq, full)
            rows = n_seq * r_pad
            kt, vt = rn(n_seq * Hkv, tail_cap, D), rn(n_seq * Hkv, tail_cap, D)
            tl = (tail_len if n_seq == 1 else torch.randint(
                0, tail_cap - 64, (n_seq * Hkv,), generator=gen, device=dev,
                dtype=torch.int32))
            k, v = rn(n_layers, rows, D), rn(n_layers, rows, D)
            kv4 = (*quant(n_layers, rows), *quant(n_layers, rows))
            layout = f"{'full' if full else 'evicted'} r_pad {r_pad} n_seq {n_seq}"
            cycle = iter(range(10 ** 9))
            for name, mode in modes:
                def run(q, layer, r=rh):
                    if mode == "bf16":
                        return flat_decode.flat_decode_attend(q, k, v, r, kt, vt, tl, scale=scale,
                                                              n_seq=n_seq, layer=layer,
                                                              seg_rows=seg)
                    return flat_decode.flat_decode_attend_int4(
                        q, *kv4, r, kt, vt, tl, scale=scale, q8=mode == "q8", n_seq=n_seq,
                        layer=layer, seg_rows=seg)

                def plain(q, layer, r=rh):
                    if mode == "bf16":
                        return flat_decode.flat_decode_attend_plain(
                            q.float(), k, v, r, kt, vt, tl, scale=scale, n_seq=n_seq,
                            layer=layer)
                    return flat_decode.flat_decode_attend_int4_plain(
                        q.float(), *kv4, r, kt, vt, tl, scale=scale, q8=mode == "q8",
                        n_seq=n_seq, layer=layer, with_slack=mode == "q8")

                for T in (1, 24):
                    q = rn(T, n_seq * H, D)
                    drop = None
                    if T == 1 and n_seq == 1 and not full:
                        rh_drop = rh.clone()
                        rh_drop[1, :64] = -1
                        drop = plain(q, 1, rh_drop)
                    hold_parity(checks, name, f"q ({T},{n_seq * H},{D}) {layout} layer 1",
                                run(q, 1), plain(q, 1), OUT_RTOL, drop)
                    row_bytes = 2 * D * 2 if mode == "bf16" else 2 * (Dp + 8)
                    other = (2 * 2 * n_seq * Hkv * (tail_len + T) * D + 2 * 2 * T * n_seq * H * D)
                    b = bound(4 * D * G * T * n_seq * (live + Hkv * (tail_len + T)),
                              n_seq * live * row_bytes + other,
                              PEAK_INT8_OPS if mode == "q8" else PEAK_FLOPS)
                    padded = bound(0, rows * row_bytes + 4 * rows + other)
                    r = dict(**kernel_ms(lambda: run(q, next(cycle) % n_layers),
                                         56 if T == 1 and n_seq == 1 else 20),
                             bound_ms=b[0], bound_by=b[1], padded_bound_ms=padded[0])
                    if T == 1 and n_seq == 1 and not full:
                        r["plain_ms"] = time_ms(lambda: plain(q, 0), 2, 1)
                    timed.setdefault(name, {})[f"T {T} {layout}"] = r
            del k, v, kv4, kt, vt, rh, seg
            torch.cuda.empty_cache()
    out = []
    for name, mode in modes:
        head = next(v for key, v in timed[name].items() if key.startswith("T 1 evicted")
                    and key.endswith("n_seq 1"))
        out.append(dict(
            name=name, route="cuda",
            source=f"kvzip_tpu_torch/csrc/{'flat_decode.cu' if mode == 'bf16' else 'flat_decode_int4.cu'}",
            replaces=f"kvzip_tpu/ops/flat_decode.py:{468 if mode == 'bf16' else 381}",
            **{k_: head[k_] for k_ in ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                                       "padded_bound_ms")},
            library_ms=None, per_shape=timed[name]))
    return verify_parity(out, checks)


def kernel_parity_w8a8(cfg, sink: int):
    """K9, K13 and K14 against their plain versions at the shapes the
    W8A8-KV4 path gives them at llama3.1-8b: K9 at a scoring chunk (2304
    padded queries, keys sink + 2048 + 2304) with a full window (ctx_len
    2000) and the context's short last window (384); K13 at D = 4096 and
    K14 at F = 14336, each at T = 1 (decode), 16 and 2304 (a scoring
    chunk), K14 also at T = 4 and 24 (its cluster form's other sizes).
    K9 through ``ops.parity`` (a reference with one 64-key window
    tile left out must fail), K13/K14 through ``ops.quant_parity`` (a
    reference with one row's scale doubled must fail). The kernels line
    carries K9 at ctx_len 2000 and K13/K14 at T = 2304; every shape's time
    is logged."""
    import torch
    import torch.nn.functional as F

    from kvzip_tpu_torch.ops import OUT_RTOL, fused_act, windowed_attend

    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    D_m, I = cfg.hidden_size, cfg.intermediate_size
    scale = D ** -0.5
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    checks, out = {}, []

    # K9
    T, s_ctx = 2304, 2048
    s0, K = sink + s_ctx, sink + s_ctx + T
    q, keys, vals = rn(T, H, D), rn(Hkv, K, D), rn(Hkv, K, D)
    kw = dict(sink=sink, s_ctx=s_ctx, scale=scale)
    timed_k9 = {}
    for ctx_len in (2000, 384):
        got = windowed_attend.windowed_attend(q, keys, vals, ctx_len, **kw)
        want, drop = (windowed_attend.windowed_attend_plain(
            q.float(), keys.float(), vals.float(), n, **kw) for n in (ctx_len, ctx_len - 64))
        hold_parity(checks, "windowed_attend",
                    f"q ({T},{H},{D}) keys ({Hkv},{K},{D}) ctx_len {ctx_len}", got, want,
                    OUT_RTOL, drop)
        col, row = torch.arange(K, device=dev)[None], torch.arange(T, device=dev)[:, None]
        mask = ~(((col >= s0) & (col - s0 > row)) | ((col >= sink + ctx_len) & (col < s0)))
        pairs = H * (T * (sink + ctx_len) + T * (T + 1) // 2)
        b = bound(4 * D * pairs, 2 * 2 * T * H * D + 2 * 2 * Hkv * K * D)
        timed_k9[ctx_len] = dict(
            **kernel_ms(lambda: windowed_attend.windowed_attend(q, keys, vals, ctx_len, **kw),
                        10),
            plain_ms=time_ms(lambda: windowed_attend.windowed_attend_plain(
                q, keys, vals, ctx_len, **kw), 2, 1),
            bound_ms=b[0], bound_by=b[1],
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(0, 1)[None], keys[None], vals[None], attn_mask=mask,
                enable_gqa=True), 10))
        del mask
    out.append(dict(name="windowed_attend", route="cuda",
                    source="kvzip_tpu_torch/csrc/windowed_attend.cu",
                    replaces="kvzip_tpu/ops/windowed_attend.py:118", **timed_k9[2000],
                    per_shape={f"ctx_len {n}": v for n, v in timed_k9.items()}))
    del q, keys, vals

    # K13 and K14
    for name, W, line, shapes in (("rmsnorm_quant", D_m, 72, (1, 16, 2304)),
                                  ("silu_mul_quant", I, 115, (1, 4, 16, 24, 2304))):
        per_shape = {}
        for T in shapes:
            if name == "rmsnorm_quant":
                x = rn(T, W) * 3
                w = (1 + 0.2 * torch.randn(W, generator=gen, device=dev)).to(torch.bfloat16)
                args = (x, w, cfg.rms_norm_eps)
                kern, plain = fused_act.rmsnorm_quant, fused_act.rmsnorm_quant_plain
                nbytes = 2 * T * W + 2 * W + T * W + 4 * T
            else:
                args = (rn(T, W) * 3, rn(T, W), cfg.hidden_act)
                kern, plain = fused_act.silu_mul_quant, fused_act.silu_mul_quant_plain
                nbytes = 2 * 2 * T * W + T * W + 4 * T
            hold_quant(checks, name, f"({T},{W})", kern(*args), plain(*args))
            # float32 operations an element: K13 square, sum, two products,
            # abs, max, divide, round; K14 about 12 with its exp or tanh
            b = bound((8 if name == "rmsnorm_quant" else 12) * T * W, nbytes, PEAK_F32)
            per_shape[f"T {T}"] = dict(**kernel_ms(lambda: kern(*args), 56),
                                       plain_ms=time_ms(lambda: plain(*args), 5, 1),
                                       bound_ms=b[0], bound_by=b[1])
        out.append(dict(name=name, route="cuda", source="kvzip_tpu_torch/csrc/fused_act.cu",
                        replaces=f"kvzip_tpu/ops/fused_act.py:{line}", **per_shape["T 2304"],
                        t1_ms=per_shape["T 1"]["ms"], library_ms=None, per_shape=per_shape))
    return verify_parity(out, checks)


TP_LOCAL = ((14, 2), (7, 1))  # qwen2.5-7b's heads on one rank at tp 2 and tp 4
RING_T = 4096


def kernel_parity_tp_local(cfg, sink: int, capacity: int, tail_cap: int) -> dict:
    """K1-K7 (K5 in both forms, K7 also in q8 mode) against their plain
    versions at a tensor-parallel rank's local head counts (``TP_LOCAL``:
    H 14 over Hkv 2, H 7 over Hkv 1) and the main path's shapes, through
    ``ops.parity``: K1 at the prefill's 4096-query chunk, K2 at a scoring
    chunk, K4 at T 1 and 8 on the 16k dense cache, K3 and K7 at T 1 and 16
    on a ~30% pool, K5 at T 4096 and 1, K6 at a scoring chunk. Each kernel
    must also reject a reference with one 64-key tile (K2: its last 16
    queries) left out at one shape. Returns the checks by kernel name."""
    import torch

    from kvzip_tpu_torch.ops import (OUT_RTOL, SCORE_RTOL, flash, flash_int4, pool_decode,
                                     ragged_decode, score_kernel)
    from kvzip_tpu_torch.ops.quant import quantize_int4
    from kvzip_tpu_torch.pool import POOL_ALIGN, plan_offsets

    L, D = cfg.num_layers, cfg.head_dim
    scale = D ** -0.5
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    prefill_len = sink + CTX
    checks = {}

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def quant(*shape):
        p, s_, z = quantize_int4(rn(*shape, D), pack="split")
        return p, s_[..., 0], z[..., 0]

    def hold(name, shape, got, want, rtol=OUT_RTOL, drop=None):
        hold_parity(checks, name, shape, got, want, rtol, drop)

    for H, Hkv in TP_LOCAL:
        tag = f"H {H} Hkv {Hkv}"
        # K1 and K4 on a dense bf16 cache
        k, v = rn(Hkv, capacity, D), rn(Hkv, capacity, D)
        kf, vf = k.float(), v.float()
        q = rn(4096, H, D)
        lens = torch.full((Hkv,), 12288, dtype=torch.int32, device=dev)
        hold("flash_attend", f"{tag} q (4096,{H},{D}) base 12288",
             flash.flash_attend(q, k, v, lens, scale=scale),
             flash.flash_attend_plain(q.float(), kf, vf, lens, scale=scale),
             drop=flash.flash_attend_plain(q.float(), kf, vf, lens - 64, scale=scale))
        lens = torch.full((Hkv,), prefill_len, dtype=torch.int32, device=dev)
        for T in (1, 8):
            q = rn(T, H, D)
            hold("ragged_decode_attend", f"{tag} q ({T},{H},{D}) live {prefill_len}",
                 ragged_decode.ragged_decode_attend(q, k, v, lens, scale=scale),
                 ragged_decode.ragged_decode_attend_plain(q.float(), kf, vf, lens, scale=scale),
                 drop=(ragged_decode.ragged_decode_attend_plain(q.float(), kf, vf, lens - 64,
                                                                scale=scale) if T == 1 else None))
        del k, v, kf, vf
        # K2 at a scoring chunk
        T, s_ctx, ctx_len = 2304, 2048, 2000
        q_valid = ctx_len + 60
        q, keys = rn(T, H, D), rn(Hkv, sink + s_ctx + T, D)
        kw = dict(sink=sink, s_ctx=s_ctx, scale=scale, model_dtype=torch.bfloat16)
        hold("fused_scores", f"{tag} q ({T},{H},{D})",
             score_kernel.fused_scores(q, keys, ctx_len, q_valid, **kw),
             score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len, q_valid, **kw),
             SCORE_RTOL, score_kernel.fused_scores_plain(q.float(), keys.float(), ctx_len,
                                                         q_valid - 16, **kw))
        # K5 (both forms) and K6 on a dense int4 cache
        kv0 = (*quant(Hkv, capacity), *quant(Hkv, capacity))
        for T, base in ((4096, 12288), (1, prefill_len)):
            q = rn(T, H, D)
            lens = torch.full((Hkv,), base, dtype=torch.int32, device=dev)
            name = "flash_attend_int4" if T > flash_int4.SPLIT_T else "flash_attend_int4_decode"
            hold(name, f"{tag} q ({T},{H},{D}) base {base}",
                 flash_int4.flash_attend_int4(q, *kv0, lens, scale=scale),
                 flash_int4.flash_attend_int4_plain(q.float(), *kv0, lens, scale=scale),
                 drop=flash_int4.flash_attend_int4_plain(q.float(), *kv0, lens - 64,
                                                         scale=scale))
        q = rn(2304, H, D)
        extra = (*quant(2304, Hkv), *quant(2304, Hkv))
        lens = torch.full((Hkv,), prefill_len, dtype=torch.int32, device=dev)
        hold("flash_attend_int4_extra", f"{tag} q (2304,{H},{D}) base {prefill_len}",
             flash_int4.flash_attend_int4_extra(q, *kv0, lens, *extra, scale=scale),
             flash_int4.flash_attend_int4_extra_plain(q.float(), *kv0, lens, *extra,
                                                      scale=scale),
             drop=flash_int4.flash_attend_int4_extra_plain(q.float(), *kv0, lens - 64, *extra,
                                                           scale=scale))
        del kv0, extra
        # K3 and K7 (and K7-q8) on a ~30% pool with a partly filled tail
        rows_h = torch.randint(int(0.2 * prefill_len), int(0.4 * prefill_len), (L, Hkv),
                               generator=torch.Generator().manual_seed(SEED + 7))
        per_layer = rows_h.sum(1).numpy()
        off, alloc, max_rows = plan_offsets(per_layer, POOL_ALIGN)
        rh = torch.full((alloc,), -1, dtype=torch.int32)
        for l in range(L):
            rh[int(off[l]):int(off[l]) + int(per_layer[l])] = torch.repeat_interleave(
                torch.arange(Hkv, dtype=torch.int32), rows_h[l])
        rh_drop = rh.clone()
        rh_drop[int(off[0]):int(off[0]) + 64] = -1
        geo = (torch.from_numpy(off).to(dev), torch.from_numpy(per_layer.astype("int32")).to(dev))
        meta, meta_drop = (rh.to(dev),) + geo, (rh_drop.to(dev),) + geo
        kt, vt = rn(L, Hkv, tail_cap, D), rn(L, Hkv, tail_cap, D)
        kp, vp = rn(alloc, D), rn(alloc, D)
        kq, ks, kz = quant(alloc)
        vq, vs, vz = quant(alloc)
        pool4 = (kq, ks.float(), kz.float(), vq, vs.float(), vz.float())
        for T in (1, 16):
            q = rn(T, H, D)
            for l in (0, L - 1):
                first = T == 1 and l == 0
                shape = f"{tag} q ({T},{H},{D}) layer {l} tail 40"
                hold("pool_decode_attend", shape,
                     pool_decode.pool_decode_attend(q, kp, vp, *meta, kt, vt, 40, l,
                                                    scale=scale, max_rows=max_rows),
                     pool_decode.pool_decode_attend_plain(q.float(), kp.float(), vp.float(),
                                                          *meta, kt.float(), vt.float(), 40, l,
                                                          scale=scale),
                     drop=pool_decode.pool_decode_attend_plain(
                         q.float(), kp.float(), vp.float(), *meta_drop, kt.float(), vt.float(),
                         40, l, scale=scale) if first else None)
                for q8 in (False, True):
                    name = "pool_decode_attend_int4" + ("_q8" if q8 else "")
                    ref = dict(q8=True, with_slack=True) if q8 else {}
                    hold(name, shape,
                         pool_decode.pool_decode_attend_int4(q, *pool4, *meta, kt, vt, 40, l,
                                                             scale=scale, max_rows=max_rows,
                                                             q8=q8),
                         pool_decode.pool_decode_attend_int4_plain(
                             q.float(), *pool4, *meta, kt.float(), vt.float(), 40, l,
                             scale=scale, **ref),
                         drop=pool_decode.pool_decode_attend_int4_plain(
                             q.float(), *pool4, *meta_drop, kt.float(), vt.float(), 40, l,
                             scale=scale, **ref) if first else None)
        del kp, vp, kt, vt, pool4
    log(phase="kernel_parity_tp_local", heads=[list(h) for h in TP_LOCAL], checks=checks)
    return checks


def init_tp_group():
    """An NCCL group over the machine's cards, at most 4 and a divisor of
    qwen2.5-7b's 4 kv heads (the smoke's own process at world size 1, a
    FileStore in a temporary directory), and its mesh: (data 1, model
    world). Returns (mesh, world)."""
    import torch
    import torch.distributed as dist

    from kvzip_tpu_torch.parallel import make_mesh

    world = max(w for w in (1, 2, 4) if w <= torch.cuda.device_count())
    if world > 1:  # tp_ranks spawns the ranks
        return None, world
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "tp_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    return make_mesh(tp=1), 1


def _tp_rank(rank: int, world: int, store_path: str, ctx_ids, queries) -> dict:
    """One rank of ``tp_ranks`` on card ``rank``: the bf16 engine from the
    smoke's seed on a (data 1, model world) NCCL mesh, the main path's
    prefill, scoring, prune(0.3, "pair") and three greedy answers."""
    import torch
    import torch.distributed as dist

    from kvzip_tpu_torch import ops
    from kvzip_tpu_torch.config import resolve_config
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.parallel import make_mesh
    from kvzip_tpu_torch.parallel.mesh import shard_of

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        cfg = resolve_config(MODEL)
        eng = Engine(MODEL, config=cfg, dtype=torch.bfloat16, device="cuda",
                     max_new_tokens=NEW_TOKENS, seed=SEED, mesh=make_mesh(tp=world))
        ops.reset_launches()
        st = eng.prefill(ctx_ids)
        eng.prune(st, 0.3, "pair")
        answers = [eng.generate_ids(q, st).tolist() for q in queries]
        sh = shard_of(cfg, eng.mesh)
        return dict(answers=answers, kv0=sh.kv0, lengths=st.cache.lengths.cpu(),
                    launches=dict(ops.LAUNCHES),
                    step_delta=eng.decode_step(st).delta[1])
    finally:
        dist.destroy_process_group()


def tp_ranks(world, ctx_ids, queries, keep):
    """``tp_path``'s holds on ``world`` cards, one spawned process a card
    (NCCL, a FileStore): every rank's answers the no-mesh engine's, its
    pool's rows those of its kv heads, its step's collectives captured.
    Returns the phase's report with rank 0's launches."""
    import torch
    import torch.multiprocessing as mp

    store = os.path.join(tempfile.mkdtemp(), "tp_store")
    mp.start_processes(_tp_rank_main, args=(world, store, ctx_ids, queries), nprocs=world,
                       start_method="spawn", join=True)
    got = [torch.load(f"{store}.rank{r}.pt", weights_only=False) for r in range(world)]
    want = keep["pool"].cache.lengths.cpu()
    for r in got:
        if r["answers"] != [a.tolist() for a in keep["answers"]]:
            raise AssertionError(f"a rank's answers {r['answers']} are not the no-mesh ones")
        h = r["lengths"].shape[1]
        if not torch.equal(r["lengths"], want[:, r["kv0"]:r["kv0"] + h]):
            raise AssertionError("a rank's pool keeps other rows than the no-mesh pool")
        if r["step_delta"].get("all_reduce model", 0) == 0:
            raise AssertionError(f"a rank's captured step holds {r['step_delta']}")
    return dict(world=world, tp=world, answers_equal=True, launches=got[0]["launches"],
                step_collectives=got[0]["step_delta"])


def _tp_rank_main(rank, world, store, ctx_ids, queries):
    import torch

    torch.save(_tp_rank(rank, world, store, ctx_ids, queries), f"{store}.rank{rank}.pt")


def tp_path(teng, eng, ctx_ids, queries, keep, world):
    """The bf16 main path through ``Engine(mesh=...)`` on the world size the
    machine gives (one card: the smoke's own NCCL group of 1), on the bf16
    engine's weights and the main path's context and queries: prefill,
    scoring, prune(0.3, "pair"), three queries on the pool through the
    captured step. Held: the pool's kept rows a head and the answers equal
    the no-mesh engine's (``keep``); one query's last logits against the
    no-mesh engine's on its pool (bit-equal expected at world size 1, where
    an NCCL sum is a copy; within OUT_RTOL of the largest logit in any
    case); the captured step's graph holds the step's collectives (2L + 1
    all-reduces and one all-gather, ``step.delta``). Then ``ring_prefill``
    and ``reshard_to_cache`` called directly on the first ``RING_T``
    tokens, their K/V against the normal prefill's: layer 0 equal, every
    layer's relative RMS distance within twice the largest of the same
    prefill in 1,000-token chunks (the schedule noise); the resharded
    cache's rows the ring's."""
    import torch

    from kvzip_tpu_torch import ops
    from kvzip_tpu_torch.cache import init_cache
    from kvzip_tpu_torch.ops import OUT_RTOL
    from kvzip_tpu_torch.parallel.mesh import axis_size, mesh_shape
    from kvzip_tpu_torch.parallel.ring_prefill import reshard_to_cache, ring_prefill

    import torch.distributed as dist

    cfg, mesh = teng.config, teng.mesh
    rep = dict(world=world, tp=axis_size(mesh, "model"), mesh=mesh_shape(mesh),
               backend=dist.get_backend(), no_mesh_ms_per_token=keep["pool_ms"])
    before = dict(ops.COLLECTIVES)
    st, rep["prefill_s"] = timed(lambda: teng.prefill(ctx_ids, do_score=False))
    _, rep["scoring_s"] = timed(lambda: teng.scoring(st, st.ctx_ids))
    (_, rep["kept_ratio"]), rep["prune_s"] = timed(lambda: teng.prune(st, 0.3, "pair"))
    want = keep["pool"]
    if getattr(st.cache, "tp", 0) != rep["tp"] or \
            not torch.equal(st.cache.lengths, want.cache.lengths):
        raise AssertionError("the mesh engine's pool keeps other rows than the no-mesh one's")
    rep["ms_per_token"], answers = decode_ms_per_token(teng, st, queries, eager=False)
    rep["answers_equal"] = all(a.tolist() == b.tolist() for a, b in zip(answers, keep["answers"]))
    if not rep["answers_equal"]:
        raise AssertionError(f"mesh answers {[a.tolist() for a in answers]} != "
                             f"{[a.tolist() for a in keep['answers']]}")
    step = teng.decode_step(st)
    rep["step_collectives"] = step.delta[1]
    L = cfg.num_layers
    if step.graph is None or step.delta[1] != {"all_reduce model": 2 * L + 1,
                                               "all_gather model": 1}:
        raise AssertionError(f"the captured step holds {step.delta[1]} collectives")
    got = torch.from_numpy(teng.forward_ids(queries[0], st, return_logits=True)[-1])
    ref = torch.from_numpy(eng.forward_ids(queries[0], want, return_logits=True)[-1])
    diff = float((got - ref).abs().max())
    rep.update(logits_max_abs_diff=diff, logits_bit_equal=bool(torch.equal(got, ref)),
               logits_max=float(ref.abs().max()))
    if diff > OUT_RTOL * float(ref.abs().max()):
        raise AssertionError(f"mesh logits differ by {diff}")
    del st
    # the ring, called directly (a "data" axis of 1 is one hop), held
    # against the normal prefill within twice the schedule noise: the
    # distance between two prefills of the same tokens in other chunks
    # (random weights carry a rounding difference through the 28 layers)
    sink = len(teng.sys_prompt_ids)
    st4 = teng.prefill(ctx_ids[:RING_T - sink], do_score=False)
    st4b = teng.prefill(ctx_ids[:RING_T - sink], prefill_chunk_size=1000, do_score=False)
    (k, v), rep["ring_prefill_s"] = timed(lambda: ring_prefill(teng.params, cfg,
                                                               st4.prefill_ids, mesh))

    def rel_rms_by_layer(got, ref):
        err = (got.float() - ref.float()).square().mean(dim=(1, 2, 3)).sqrt()
        return (err / ref.float().square().mean(dim=(1, 2, 3)).sqrt()).tolist()

    ring = {}
    for f, got in (("k", k), ("v", v)):
        ref = getattr(st4.cache, f)[:, :, :RING_T]
        floor = rel_rms_by_layer(getattr(st4b.cache, f)[:, :, :RING_T], ref)
        dist_ = rel_rms_by_layer(got, ref)
        ring[f] = dict(rel_rms_by_layer=dist_, floor_by_layer=floor,
                       max_abs=float((got.float() - ref.float()).abs().max()),
                       layer0_equal=bool(torch.equal(got[0], ref[0])))
        # (1e-5: float32's own spread, where two schedules agree bit for bit)
        if not ring[f]["layer0_equal"] or max(dist_) > 2 * max(floor) + 1e-5:
            raise AssertionError(f"ring {f} differs from the prefill's: {ring[f]}")
    del st4b
    cache = init_cache(teng.cache_config, st4.cache.capacity, teng.dtype, teng.device)
    _, rep["reshard_s"] = timed(lambda: reshard_to_cache(k, v, mesh, cache))
    if not (torch.equal(cache.k[:, :, :RING_T], k) and int(cache.seen) == RING_T
            and bool((cache.lengths == RING_T).all())):
        raise AssertionError("reshard_to_cache did not place the ring's rows")
    rep["ring"] = ring
    rep["collectives"] = {n: c - before.get(n, 0) for n, c in ops.COLLECTIVES.items()}
    return rep


def allkept_attention(cache, pool, num_heads: int):
    """Attention on the all-rows-kept pool against the dense cache, layer by
    layer on the same q and the same T new rows (written at each head's
    length in a copy of the dense layer, and at the start of a copy of the
    pool's tail). The pool holds the dense cache's rows, so K3 on it and K4
    (T = 1) or K1 (T = 16) on the dense cache each pass ``ops.parity``
    against the dense float32 reference. Its launches are not counted."""
    import torch

    from kvzip_tpu_torch.ops import (LAUNCHES, OUT_RTOL, flash, parity, pool_decode,
                                     ragged_decode)

    saved = dict(LAUNCHES)
    L, Hkv, C, D = cache.k.shape
    scale = D ** -0.5
    gen = torch.Generator(device=cache.k.device).manual_seed(SEED + 1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=cache.k.device).to(cache.k.dtype)

    kt, vt = pool.k_tail.clone(), pool.v_tail.clone()
    worst = dict(pool_vs_dense=0.0, dense_kernel_vs_dense=0.0)
    max_k3_minus_dense_kernel = 0.0
    for T in (1, 16):
        for l in range(L):
            q, kn, vn = rn(T, num_heads, D), rn(Hkv, T, D), rn(Hkv, T, D)
            lens = cache.lengths[l]
            kd, vd = cache.k[l].clone(), cache.v[l].clone()
            for h, n in enumerate(lens.tolist()):
                kd[h, n:n + T], vd[h, n:n + T] = kn[h], vn[h]
            kt[l, :, :T], vt[l, :, :T] = kn, vn
            want = ragged_decode.ragged_decode_attend_plain(q.float(), kd.float(), vd.float(),
                                                            lens, scale=scale)
            got3 = pool_decode.pool_decode_attend(
                q, pool.k_pool, pool.v_pool, pool.row_head, pool.layer_off,
                pool.layer_rows, kt, vt, 0, l, scale=scale, max_rows=pool.max_rows)
            dense_kernel = ragged_decode.ragged_decode_attend if T <= 8 else flash.flash_attend
            got_d = dense_kernel(q, kd, vd, lens, scale=scale)
            for key, got in (("pool_vs_dense", got3), ("dense_kernel_vs_dense", got_d)):
                r = parity(got, want, OUT_RTOL)
                if not r["ok"]:
                    raise AssertionError(f"all-kept attention, T={T} layer {l}, {key}: {r}")
                worst[key] = max(worst[key], r["worst_to_tol"])
            max_k3_minus_dense_kernel = max(
                max_k3_minus_dense_kernel, (got3.float() - got_d.float()).abs().max().item())
    LAUNCHES.update(saved)
    stats = dict(worst_to_tol=worst, max_k3_minus_dense_kernel=max_k3_minus_dense_kernel)
    log(phase="allkept_attention", layers=L, T=[1, 16], **stats)
    return stats


def teacher_forced(eng, state, seq, step: bool):
    """Logits of every position of seq on state's cache (restored after):
    in the engine's chunks, or one token per forward."""
    import numpy as np

    if not step:
        return eng.forward_ids(seq, state, return_logits=True)
    state.snapshot()
    out = [eng.forward_ids(seq[i:i + 1], state, update_cache=True, return_logits=True)
           for i in range(len(seq))]
    state.restore_snapshot()
    return np.concatenate(out)


def allkept_check(eng, dense, full, query, dense_ans, full_eng=None,
                  phase="allkept_check", full_step=False):
    """An all-rows-kept pool holds the same KV as the dense cache, so its
    answer must be the dense answer. Both run in bf16 through different
    kernels (K3 against K1/K4), so logits agree only to bf16 rounding; the
    noise floor is measured as the difference between two equivalent
    schedules on the dense cache (chunked against token by token). The
    same hold compares any two caches of the same rows: ``full`` decoded by
    ``full_eng`` (the flat layout against the pool); with ``full_step`` the
    other side runs token by token and is compared with the token-by-token
    dense logits (a route that only runs at decode shapes).

    Holds: (1) teacher-forced logits of the pool agree with the dense ones
    within twice that floor; (2) their argmax agrees wherever the dense
    top-2 gap exceeds the pool/dense difference; (3) the free-running greedy
    answers are equal token for token up to the first such near-tie."""
    import numpy as np

    full_eng = full_eng or eng
    full_ans = full_eng.generate_ids(query, full)
    seq = np.concatenate([query, dense_ans])
    l_dense = teacher_forced(eng, dense, seq, step=False)
    l_steps = teacher_forced(eng, dense, seq, step=True)
    l_full = teacher_forced(full_eng, full, seq, step=full_step)
    return hold_logits(phase, l_dense, l_steps, l_full, full_step, query, dense_ans, full_ans)


def hold_logits(phase, l_dense, l_steps, l_full, full_step, query, dense_ans, full_ans,
                floor=None, **extra):
    """``allkept_check``'s holds on teacher-forced logits along
    ``dense_ans``: the reference's in chunks (``l_dense``) and token by
    token (``l_steps``), the other path's (``l_full``, compared with
    ``l_steps`` where ``full_step``) and its own greedy answer
    ``full_ans``. ``floor``: a noise floor that replaces the schedule's
    where it is larger. ``extra`` goes into the logged line."""
    import numpy as np

    for a in (l_dense, l_steps, l_full):
        if not np.isfinite(a).all():
            raise AssertionError("non-finite logits")
    floor = max(float(np.abs(l_dense - l_steps).max()), floor or 0.0)
    l_ref = l_steps if full_step else l_dense
    diff = float(np.abs(l_ref - l_full).max())
    top2 = np.sort(l_ref, axis=-1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    agree = l_ref.argmax(-1) == l_full.argmax(-1)
    # answer token i is predicted at position len(query) - 1 + i
    ans_gap = gap[len(query) - 1:len(query) - 1 + len(dense_ans)]
    near = np.nonzero(ans_gap <= diff)[0]
    first_near = int(near[0]) if len(near) else len(dense_ans)
    mism = np.nonzero(full_ans[:len(dense_ans)] != dense_ans[:len(full_ans)])[0]
    first_mism = int(mism[0]) if len(mism) else None
    stats = dict(
        noise_floor=floor, max_logit_diff=diff, logit_absmax=float(np.abs(l_dense).max()),
        argmax_agree=f"{int(agree.sum())}/{len(agree)}",
        greedy_equal=bool(np.array_equal(full_ans, dense_ans)),
        first_greedy_mismatch=first_mism, first_near_tie=first_near)
    log(phase=phase, **stats, **extra)
    if diff > 2 * floor:
        raise AssertionError(f"{phase}: logits differ by {diff} > 2 x {floor}")
    if not (agree | (gap <= diff)).all():
        raise AssertionError(f"{phase}: argmax differs at a clear margin")
    if first_mism is not None and first_mism < first_near:
        raise AssertionError(
            f"{phase}: answer {full_ans.tolist()} departs from {dense_ans.tolist()} at "
            f"{first_mism}, before any near-tie")
    return stats


# -------------------------------------------------------------- main path
def timed(fn):
    """fn()'s result and its host-clock seconds between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def step_device_ms(eng, state, iters: int = 20) -> float:
    """The captured decode step's device time on ``state``: CUDA events
    around ``iters`` back-to-back replays of its graph with its answer
    ended (``done`` set: the same kernels on the same shapes, nothing
    advanced; the next generate starts a new answer)."""
    step = eng.decode_step(state)
    step.done.fill_(1)
    return time_ms(step.graph.replay, iters)


def decode_ms_per_token(eng, state, queries, eager: bool = True):
    """Per query, (t(32 new tokens) - t(2 new tokens)) / 30 on the host
    clock, after one warm-up call of each loop on the state (the first
    captures the step): ``ms_per_token`` through ``generate_ids`` (the
    captured step, replayed; the host reads the answer every
    ``DECODE_CHUNK`` steps), ``eager_ms_per_token`` through the per-token
    loop (``generate_ids_per_token``: a forward issued from Python and a
    host read a token), their means and per-query values; and the step's
    device time (``step_device_ms``). The two loops' answers must be equal
    token for token. ``eager`` False leaves the per-token loop out (a state
    whose loops were held already)."""
    import numpy as np

    from kvzip_tpu_torch.engine import generate_ids_per_token

    rep = {"ms_per_token": [], "eager_ms_per_token": []}
    answers = []
    loops = [(eng.generate_ids, "ms_per_token")]
    if eager:
        loops.append((lambda q, st, **kw: generate_ids_per_token(eng, q, st, **kw),
                      "eager_ms_per_token"))
    for loop, key in loops:
        loop(queries[0], state, max_new_tokens=2)  # warm-up
        for i, qids in enumerate(queries):
            ans, t_long = timed(lambda: loop(qids, state))
            ans2, t_short = timed(lambda: loop(qids, state, max_new_tokens=2))
            if len(ans) <= len(ans2):
                raise AssertionError("answer stopped before the timed window")
            rep[key].append((t_long - t_short) / (len(ans) - len(ans2)) * 1e3)
            if key == "ms_per_token":
                answers.append(ans)
            elif not np.array_equal(ans, answers[i]):
                raise AssertionError(f"the captured step's answer {answers[i].tolist()} is not "
                                     f"the per-token loop's {ans.tolist()}")
    rep["device_ms_per_token"] = step_device_ms(eng, state)
    out = {k: float(np.mean(v)) for k, v in rep.items() if isinstance(v, list) and v}
    out.update(device_ms_per_token=rep["device_ms_per_token"],
               per_query=rep["ms_per_token"], eager_per_query=rep["eager_ms_per_token"])
    return out, answers


def allkept_attention_int4(cache, pool, num_heads: int):
    """K7 on the all-rows-kept int4 pool against K5 on the dense int4 cache,
    layer by layer on the same q and the same T new rows: quantized and
    written at each head's length in a copy of the dense layer, and
    dequantized to bf16 at the start of a copy of the pool's tail. Both
    pass ``ops.parity`` against the float32 plain version on the dense
    rows. Its launches are not counted."""
    import torch

    from kvzip_tpu_torch.ops import LAUNCHES, OUT_RTOL, flash_int4, parity, pool_decode
    from kvzip_tpu_torch.ops.quant import dequantize_int4, quantize_int4

    saved = dict(LAUNCHES)
    L, Hkv, C, _ = cache.k_q.shape
    D = pool.k_tail.shape[-1]
    scale = D ** -0.5
    dev = cache.k_q.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    kt, vt = pool.k_tail.clone(), pool.v_tail.clone()
    pool_arrays = (pool.k_pool_q, pool.k_pool_s, pool.k_pool_z, pool.v_pool_q,
                   pool.v_pool_s, pool.v_pool_z, pool.row_head, pool.layer_off,
                   pool.layer_rows)
    worst = dict(pool_vs_dense=0.0, dense_kernel_vs_dense=0.0)
    max_k7_minus_k5 = 0.0
    for T in (1, 16):
        for l in range(L):
            q = rn(T, num_heads, D)
            lens = cache.lengths[l]
            dense = [a[l].clone() for a in (cache.k_q, cache.k_s, cache.k_z,
                                            cache.v_q, cache.v_s, cache.v_z)]
            for i, tail in ((0, kt), (3, vt)):
                p, s_, z = quantize_int4(rn(Hkv, T, D), pack="split")
                for h, n in enumerate(lens.tolist()):
                    dense[i][h, n:n + T] = p[h]
                    dense[i + 1][h, n:n + T] = s_[h, :, 0]
                    dense[i + 2][h, n:n + T] = z[h, :, 0]
                tail[l, :, :T] = dequantize_int4(p, s_, z, tail.dtype, pack="split")
            want = flash_int4.flash_attend_int4_plain(q.float(), *dense, lens, scale=scale)
            got7 = pool_decode.pool_decode_attend_int4(
                q, *pool_arrays, kt, vt, 0, l, scale=scale, max_rows=pool.max_rows)
            got5 = flash_int4.flash_attend_int4(q, *dense, lens, scale=scale)
            for key, got in (("pool_vs_dense", got7), ("dense_kernel_vs_dense", got5)):
                r = parity(got, want, OUT_RTOL)
                if not r["ok"]:
                    raise AssertionError(f"all-kept int4 attention, T={T} layer {l}, {key}: {r}")
                worst[key] = max(worst[key], r["worst_to_tol"])
            max_k7_minus_k5 = max(max_k7_minus_k5,
                                  (got7.float() - got5.float()).abs().max().item())
    LAUNCHES.update(saved)
    stats = dict(worst_to_tol=worst, max_k7_minus_k5=max_k7_minus_k5)
    log(phase="allkept_attention_int4", layers=L, T=[1, 16], **stats)
    return stats


# -------------------------------------------------------------- main paths
def main_path(eng, ctx_ids, queries, quant: bool = False, keep: dict = None):
    """The engine's main path at the smoke configuration; ``quant`` takes
    the int4 / W4A8 engine's branches (dense int4 cache, int4 pool). With
    ``keep``, a copy of the scored dense state (``keep["scored"]``), the
    pruned pool state and its answers stay for the flat layout's phases."""
    import torch

    from kvzip_tpu_torch.pool import build_pool_int4_stepped, build_pool_stepped

    cfg = eng.config
    rep = {}
    st, rep["prefill_s"] = timed(lambda: eng.prefill(ctx_ids, do_score=False))
    _, rep["scoring_s"] = timed(lambda: eng.scoring(st, st.ctx_ids))
    score = st.score
    if score.shape != (cfg.num_layers, cfg.num_kv_heads, len(ctx_ids)) \
            or not torch.isfinite(score).all() or not (score >= 0).all():
        raise AssertionError(f"bad scores: {tuple(score.shape)}")
    rep["kv_bytes_dense"] = int(st.cache.used_bytes())
    if keep is not None:
        keep["scored"] = dataclasses.replace(st, cache=copy.deepcopy(st.cache),
                                             score=st.score.clone())

    dense_ans, rep["dense_generate_s"] = timed(lambda: eng.generate_ids(queries[0], st))

    keep_all = torch.ones((cfg.num_layers, cfg.num_kv_heads, st.ctx_len), dtype=torch.bool,
                          device=eng.device)
    build = build_pool_int4_stepped if quant else build_pool_stepped
    full = dataclasses.replace(
        st, cache=build(st.cache, keep_all, st.sink, eng.decode_budget), pruned=True)
    full.snapshot()
    if quant:
        rep["allkept_attention_int4"] = allkept_attention_int4(st.cache, full.cache,
                                                               cfg.num_heads)
    else:
        rep["allkept_attention"] = allkept_attention(st.cache, full.cache, cfg.num_heads)
        rep["allkept"] = allkept_check(eng, st, full, queries[0], dense_ans)
    del full

    (thres, ratio), rep["prune_s"] = timed(lambda: eng.prune(st, 0.3, "pair"))
    rep["kept_ratio"] = ratio
    rep["kv_bytes_pruned"] = int(st.cache.used_bytes())

    rep["evicted_ms_per_token"], answers = decode_ms_per_token(eng, st, queries)
    if st.cache.tail_len != 0:
        raise AssertionError("the O(1) restore left rows in the tail")
    base = eng.synthetic_full_pool_state(st, quant, eng.decode_budget)
    rep["full_ms_per_token"], _ = decode_ms_per_token(eng, base, queries)
    rep["kv_bytes_allocated"] = pool_bytes(st.cache)
    rep["full_kv_bytes_allocated"] = pool_bytes(base.cache)
    rep["dense_answer_tokens"] = dense_ans.tolist()
    rep["answer_tokens"] = [a.tolist() for a in answers]
    if keep is not None:
        keep.update(pool=st, answers=answers, pool_ms=rep["evicted_ms_per_token"])
    return rep


def pool_bytes(pool) -> int:
    """Bytes a pool allocates for K and V: every layer's padded segment
    (packed rows and float32 scales and zeros for int4) and the tails."""
    ctx = sum(getattr(pool, f).numel() * getattr(pool, f).element_size()
              for f in ("k_pool", "v_pool", "k_pool_q", "v_pool_q", "k_pool_s", "k_pool_z",
                        "v_pool_s", "v_pool_z") if hasattr(pool, f))
    return ctx + 2 * pool.k_tail.numel() * pool.k_tail.element_size()


def flat_path(feng, keep, queries, quant: bool):
    """The legacy flat layout on the same kept rows as the pool: the scored
    copy (``keep["scored"]``) pruned by ``feng`` (``flat_decode="legacy"``;
    the same scores give the same keep mask, asserted by the lengths), then
    decode ms/token over it and over the full flat layout
    (``synthetic_full_flat_state``), live and allocated KV bytes."""
    import torch

    st = keep.pop("scored")
    pool = keep["pool"].cache
    (_, ratio), secs = timed(lambda: feng.prune(st, 0.3, "pair"))
    rep = dict(prune_s=secs, kept_ratio=ratio)
    if not torch.equal(st.cache.lengths, pool.lengths):
        raise AssertionError("the flat layout kept other rows than the pool")
    rep.update(r_pad=st.cache.capacity, kv_bytes_pruned=int(st.cache.used_bytes()),
               kv_bytes_allocated=st.cache.mem_bytes())
    rep["evicted_ms_per_token"], answers = decode_ms_per_token(feng, st, queries)
    if st.cache.tail_len != 0:
        raise AssertionError("the O(1) restore left rows in the flat tail")
    base = feng.synthetic_full_flat_state(st, quant, feng.decode_budget)
    rep["full_ms_per_token"], _ = decode_ms_per_token(feng, base, queries)
    rep.update(full_r_pad=base.cache.capacity, full_kv_bytes_allocated=base.cache.mem_bytes(),
               answer_tokens=[a.tolist() for a in answers])
    keep.update(flat=st, flat_answers=answers)
    return rep


def token_agreement(answers, refs):
    """Per pair of greedy answers: the share of their common positions
    where the tokens agree, and the first position where they part (None
    where they never do)."""
    import numpy as np

    same, first = [], []
    for a, b in zip(answers, refs):
        n = min(len(a), len(b))
        eq = a[:n] == b[:n]
        same.append(float(eq.mean()) if n else 1.0)
        first.append(int(np.argmin(eq)) if not eq.all() else None)
    return same, first


def q8_path(qeng, state, queries, exact_answers, full_state):
    """Decode with ``attn_quant="int8"`` on an int4 state (pool or flat):
    ms/token over it and over its full layout, and how far its greedy
    answers follow the exact mode's on the same queries."""
    rep = {}
    rep["evicted_ms_per_token"], answers = decode_ms_per_token(qeng, state, queries)
    rep["full_ms_per_token"], _ = decode_ms_per_token(qeng, full_state(), queries)
    same, first = token_agreement(answers, exact_answers)
    rep.update(answer_tokens=[a.tolist() for a in answers], token_agreement=same,
               first_mismatch=first)
    return rep


def fused_path(feng, eng, state, queries, composed_answers, full_state):
    """Decode with ``fuse_layer="on"`` (K12) on the quantized pool state:
    ms/token over it and over the full int4 pool, beside the composed
    route's (``eng``) on the same states in the same run (its launches not
    counted); K12's launches in one single-token decode forward (one a
    layer); the fused answers' agreement with the composed ones, and
    teacher-forced logits held to the composed path's own schedule noise
    (``allkept_check``)."""
    from kvzip_tpu_torch.ops import LAUNCHES

    rep = {}
    full = full_state()
    saved = dict(LAUNCHES)
    rep["composed_evicted_ms_per_token"], _ = decode_ms_per_token(eng, state, queries)
    rep["composed_full_ms_per_token"], _ = decode_ms_per_token(eng, full, queries)
    LAUNCHES.update(saved)
    rep["evicted_ms_per_token"], answers = decode_ms_per_token(feng, state, queries)
    rep["full_ms_per_token"], _ = decode_ms_per_token(feng, full, queries)
    before = LAUNCHES["w4a8_layer_fused"]
    feng.forward_ids(queries[0][:1], state)
    rep["fused_launches_per_forward"] = LAUNCHES["w4a8_layer_fused"] - before
    if rep["fused_launches_per_forward"] != feng.config.num_layers:
        raise AssertionError(f"fused layer ran {rep['fused_launches_per_forward']} times in "
                             f"one {feng.config.num_layers}-layer decode forward")
    same, first = token_agreement(answers, composed_answers)
    rep.update(answer_tokens=[a.tolist() for a in answers], token_agreement=same,
               first_mismatch=first)
    rep["logits"] = allkept_check(eng, state, state, queries[0], composed_answers[0],
                                  full_eng=feng, phase="fused_vs_composed_logits",
                                  full_step=True)
    return rep


def v1_path(veng, ctx_ids, queries):
    """The v1 W4A8 tree (``weight_quant="none"``, unfused, every projection
    through K15 below 512 rows) through the main path, then K15's launches
    in one single-token decode forward on its pool (seven a layer)."""
    from kvzip_tpu_torch.ops import LAUNCHES

    keep = {}
    rep = main_path(veng, ctx_ids, queries, quant=True, keep=keep)
    before = LAUNCHES["w4a8_matmul_stacked"]
    veng.forward_ids(queries[0][:1], keep["pool"])
    rep["k15_launches_per_forward"] = LAUNCHES["w4a8_matmul_stacked"] - before
    if rep["k15_launches_per_forward"] != 7 * veng.config.num_layers:
        raise AssertionError(f"K15 ran {rep['k15_launches_per_forward']} times in one "
                             f"{veng.config.num_layers}-layer decode forward")
    return rep


def v1_vs_v2(veng, eng, state, queries, v2_answers):
    """The v1 engine against the flagship's composed v2 engine on the
    flagship's scored pool state: both hold the same int4 grid (v1_tree is
    the tree the flagship draws before its repack) and differ by v2's
    bf16-rounded pre-folded zero. Decode ms/token of both in the same run,
    greedy agreement, and teacher-forced logits held to twice the v2 path's
    own schedule noise (``allkept_check``). Launches are not counted."""
    from kvzip_tpu_torch.ops import LAUNCHES

    saved = dict(LAUNCHES)
    rep = {}
    rep["v2_ms_per_token"], _ = decode_ms_per_token(eng, state, queries)
    rep["v1_ms_per_token"], answers = decode_ms_per_token(veng, state, queries)
    same, first = token_agreement(answers, v2_answers)
    rep.update(token_agreement=same, first_mismatch=first,
               answer_tokens=[a.tolist() for a in answers])
    rep["logits"] = allkept_check(eng, state, state, queries[0], v2_answers[0], full_eng=veng,
                                  phase="v1_vs_v2_logits")
    LAUNCHES.update(saved)
    log(phase="v1_vs_v2", **rep)
    return rep


def int4h_path(heng, veng, state, queries, checks):
    """``embed_quant="int4h"`` (the int4 lm_head through K8, OUT = the
    vocabulary) on the v1 layers: decode ms/token and answers on the
    flagship's pool state; then, for each query and its answer, the int4
    head's teacher-forced logits against the int8 head's (``veng``, the same
    layers and embedding, so the same hidden states): max |difference| over
    max |logit| and argmax agreement, held to the reference's bound
    (``tests/test_quant.py``: below 0.2, the argmax kept wherever the top-2
    margin exceeds 0.3 of the largest |logit|). Then K8 at the head's shape
    (152,064 columns: a grid of several column blocks a split, which no
    shape of ``kernel_parity_int4`` gives it) is held against its plain
    version on the head's own weights, into ``checks``, at every row count
    this path sends the head: 1 (each decode step and a query's last row)
    and the pool ladder's chunks of each teacher-forced sequence, each with
    a perturbed reference (one input group dropped) that must fail; then
    its device time alone at T = 1. ``veng``'s launches and those of the
    holds and timings are not counted."""
    import numpy as np
    import torch

    from kvzip_tpu_torch.engine import POOL_LADDER, ladder_split
    from kvzip_tpu_torch.ops import LAUNCHES, OUT_RTOL
    from kvzip_tpu_torch.ops.w4a8_v2 import w4a8_jnp_v2, w4a8_matmul_stacked_v2

    rep = {}
    vocab = 2 * heng.params["lm_head"]["q4"].shape[-1]
    if vocab != heng.config.vocab_size:
        raise AssertionError(f"int4 head of {vocab} columns")
    rep["ms_per_token"], answers = decode_ms_per_token(heng, state, queries)
    errs, agree, clear_kept = [], [], True
    for qids, ans in zip(queries, answers):
        seq = np.concatenate([qids, ans])
        l4 = teacher_forced(heng, state, seq, step=False)
        saved = dict(LAUNCHES)
        l8 = teacher_forced(veng, state, seq, step=False)
        LAUNCHES.update(saved)
        if not (np.isfinite(l4).all() and np.isfinite(l8).all()):
            raise AssertionError("int4h: non-finite logits")
        absmax = float(np.abs(l8).max())
        errs.append(float(np.abs(l4 - l8).max()) / absmax)
        agree.append(float((l4.argmax(-1) == l8.argmax(-1)).mean()))
        top2 = np.sort(l8, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 0.3 * absmax
        clear_kept &= bool((l4.argmax(-1)[clear] == l8.argmax(-1)[clear]).all())
    # K8 at the head's shape: held at every row count sent here, then timed
    head, D = heng.params["lm_head"], heng.config.hidden_size
    w0 = {k: v[0] for k, v in head.items()}
    rows = sorted({1, *(n for qids, ans in zip(queries, answers)
                        for n in ladder_split(len(qids) + len(ans), POOL_LADDER))})
    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    saved = dict(LAUNCHES)
    for T in rows:
        x = torch.randn(T, D, device="cuda", generator=gen).to(torch.bfloat16)
        got = w4a8_matmul_stacked_v2(x, head["q4"], head["s2"], head["z2"], 0)
        xd = x.float().clone()
        xd[:, 128:256] = 0
        hold_parity(checks, "w4a8_matmul_stacked_v2", f"lm_head {D}->{vocab} T {T}", got,
                    w4a8_jnp_v2(x.float(), w0), OUT_RTOL, w4a8_jnp_v2(xd, w0))
    xf = x[:1]
    t = kernel_ms(lambda: w4a8_matmul_stacked_v2(xf, head["q4"], head["s2"], head["z2"], 0), 20)
    LAUNCHES.update(saved)
    b = bound(2 * D * vocab, D * vocab // 2 + 2 * head["s2"].numel() * 2 + 2 * D + 2 * vocab,
              PEAK_INT8_OPS)
    rep.update(head_k8_ms=t["ms"], head_k8_host_ms=t["host_ms"], head_k8_bound_ms=b[0],
               head_k8_bound_by=b[1], head_k8_rows=rows, vocab=vocab, head_rel_err=errs,
               argmax_agreement=agree, clear_margin_argmax_kept=clear_kept,
               answer_tokens=[a.tolist() for a in answers])
    if max(errs) >= 0.2 or not clear_kept:
        log(phase="int4h_head_failed", **rep)
        raise AssertionError(f"int4 head: error {max(errs)} (bound 0.2), clear-margin "
                             f"argmax kept {clear_kept}")
    return rep


# a small qwen2 checkpoint (head_dim 128, as the kernels take)
CKPT_CONFIG = dict(model_type="qwen2", vocab_size=1024, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                   max_position_embeddings=4096, rope_theta=1000000.0, rms_norm_eps=1e-6,
                   tie_word_embeddings=False, hidden_act="silu")
CKPT_LINEARS = {"self_attn.q_proj": "wq", "self_attn.k_proj": "wk", "self_attn.v_proj": "wv",
                "self_attn.o_proj": "wo", "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
                "mlp.down_proj": "w_down"}
CKPT_VECTORS = {"self_attn.q_proj.bias": "bq", "self_attn.k_proj.bias": "bk",
                "self_attn.v_proj.bias": "bv", "input_layernorm.weight": "ln_attn",
                "post_attention_layernorm.weight": "ln_mlp"}


def write_checkpoint(path: str, tensors: dict) -> None:
    """``config.json`` and two shards: the embedding and layer 0, the rest."""
    os.makedirs(path, exist_ok=True)
    first = {k: v for k, v in tensors.items()
             if k.startswith(("model.embed", "model.layers.0."))}
    write_safetensors(os.path.join(path, "model-00001-of-00002.safetensors"), first)
    write_safetensors(os.path.join(path, "model-00002-of-00002.safetensors"),
                      {k: v for k, v in tensors.items() if k not in first})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(CKPT_CONFIG, f)


def checkpoint_load(tokenizer):
    """A small qwen2 checkpoint written by ``write_checkpoint`` (bf16, from
    a seed) and its QServe-style W8A8 export (int8 projections, float32
    ``dequant_scale``), loaded on the card by ``Engine(<dir>)`` through the
    port's own safetensors reader: the bf16 one with
    ``weight_quant="w4a8"`` (stream-quantized, fused, repacked to v2), the
    W8A8 one as it is. Each loaded tree must equal the tree written,
    quantized the same way by ``prepare_params``; each engine answers one
    query on a 300-token context; K8 must run on the W4A8 one."""
    import tempfile

    import numpy as np
    import torch

    from kvzip_tpu_torch.config import ModelConfig
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.models.params import prepare_params
    from kvzip_tpu_torch.ops import LAUNCHES, reset_launches

    c = CKPT_CONFIG
    D, I, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    kv = c["num_key_value_heads"] * D // c["num_attention_heads"]
    outs = dict(wq=D, wk=kv, wv=kv, wo=D, w_gate=I, w_up=I, w_down=D)
    ins = dict(wq=D, wk=D, wv=D, wo=D, w_gate=D, w_up=D, w_down=I)
    vec = dict(bq=D, bk=kv, bv=kv, ln_attn=D, ln_mlp=D)
    g = torch.Generator().manual_seed(SEED + 11)

    def rn(*shape, std=0.05, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(torch.bfloat16)

    hf = {"model.embed_tokens.weight": rn(V, D), "lm_head.weight": rn(V, D),
          "model.norm.weight": rn(D, std=0.1, mean=1.0)}
    layers = {}
    for l in range(L):
        for name, slot in CKPT_LINEARS.items():
            w = rn(outs[slot], ins[slot])  # HF's (out, in)
            hf[f"model.layers.{l}.{name}.weight"] = w
            layers.setdefault(slot, []).append(w.T)
        for name, slot in CKPT_VECTORS.items():
            t = rn(vec[slot], std=0.1, mean=1.0 if slot.startswith("ln") else 0.0)
            hf[f"model.layers.{l}.{name}"] = t
            layers.setdefault(slot, []).append(t)
    # on the card, so that prepare_params quantizes it as the loader does
    written = {"embed": hf["model.embed_tokens.weight"].cuda(),
               "lm_head": hf["lm_head.weight"].cuda(),
               "final_norm": hf["model.norm.weight"].cuda(),
               "layers": {k: torch.stack(v).cuda() for k, v in layers.items()}}
    w8 = dict(hf)
    w8_layers = {k: v for k, v in written["layers"].items() if k in vec}
    for name, slot in CKPT_LINEARS.items():
        qs, ss = [], []
        for l in range(L):
            wf = hf[f"model.layers.{l}.{name}.weight"].float()
            sc = wf.abs().amax(dim=1) / 127.0 + 1e-8
            q = torch.clamp(torch.round(wf / sc[:, None]), -127, 127).to(torch.int8)
            w8[f"model.layers.{l}.{name}.weight"] = q
            w8[f"model.layers.{l}.{name}.dequant_scale"] = sc
            qs.append(q)
            ss.append(sc)
        w8_layers[slot] = {"q": torch.stack(qs), "s": torch.stack(ss)}

    def same(got, want, path=""):
        if isinstance(want, dict):
            if sorted(got) != sorted(want):
                raise AssertionError(f"{path}: keys {sorted(got)} != {sorted(want)}")
            for k in want:
                same(got[k], want[k], f"{path}/{k}")
        elif got.dtype != want.dtype or not torch.equal(got, want.to(got.device)):
            raise AssertionError(f"loaded tree differs from the written one at {path}")

    rep = {}
    rng = np.random.default_rng(SEED + 11)
    ctx = rng.integers(0, 256, 300).astype(np.int32)
    query = rng.integers(0, 256, 24).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        bf16_dir, w8_dir = os.path.join(tmp, "qwen2-bf16"), os.path.join(tmp, "qwen2-w8a8")
        write_checkpoint(bf16_dir, hf)
        write_checkpoint(w8_dir, w8)
        cfg = ModelConfig.from_json(os.path.join(bf16_dir, "config.json"), name=bf16_dir)
        for tag, path, wq, want in (
                ("w4a8", bf16_dir, "w4a8",
                 prepare_params(cfg, {**written, "layers": dict(written["layers"])},
                                dtype=torch.bfloat16, weight_quant="w4a8", device="cuda")),
                ("w8a8", w8_dir, "none", {**written, "layers": w8_layers})):
            reset_launches()
            t0 = time.perf_counter()
            e = Engine(path, tokenizer=tokenizer, weight_quant=wq, max_new_tokens=8,
                       device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            same(e.params, want)
            st = e.prefill(ctx)
            ans = e.generate_ids(query, st)
            if len(ans) == 0 or not np.isfinite(e.forward_ids(query, st, return_logits=True)).all():
                raise AssertionError(f"checkpoint engine ({tag}) gave no answer")
            rep[tag] = dict(load_s=load_s, answer_tokens=ans.tolist(),
                            launches={k: v for k, v in LAUNCHES.items() if v})
            if tag == "w4a8" and not LAUNCHES["w4a8_matmul_stacked_v2"]:
                raise AssertionError("the loaded W4A8 checkpoint did not run through K8")
            del e, st
    log(phase="checkpoint_load", config=CKPT_CONFIG, **rep)
    return rep


def q8_logits(eng, qeng, state, queries, answers, phase):
    """Teacher-forced logits of the exact mode (``eng``) and the int8
    attention (``qeng``) on each query followed by the exact mode's answer:
    the share of answer positions where their argmax agrees, and the
    largest logit difference beside the logits' size. Launches are not
    counted."""
    import numpy as np

    from kvzip_tpu_torch.ops import LAUNCHES

    saved = dict(LAUNCHES)
    agree, diff, absmax = [], 0.0, 0.0
    for qids, ans in zip(queries, answers):
        seq = np.concatenate([qids, ans])
        le = teacher_forced(eng, state, seq, step=False)
        lq = teacher_forced(qeng, state, seq, step=False)
        pos = slice(len(qids) - 1, len(seq) - 1)  # the predictions of the answer tokens
        agree.append(float((le[pos].argmax(-1) == lq[pos].argmax(-1)).mean()))
        diff = max(diff, float(np.abs(le - lq).max()))
        absmax = max(absmax, float(np.abs(le).max()))
    LAUNCHES.update(saved)
    stats = dict(argmax_agreement=agree, max_logit_diff=diff, logit_absmax=absmax)
    log(phase=phase, **stats)
    return stats


def cross_layout_attention(pool, flat, num_heads: int, int4: bool):
    """Attention on the flat layout against the pool, layer by layer on the
    same kept rows, the same q and the same T new rows written at the start
    of a copy of each layout's tail: K10 against K3 (or K11 against K7),
    each held with ``ops.parity`` against the pool's float32 plain version.
    For int4 also the int8 mode's cost: K11-q8 and K7-q8 held against their
    plain q8 versions, and the relative RMS of their outputs against the
    exact kernels'. Launches are not counted."""
    import torch

    from kvzip_tpu_torch.ops import LAUNCHES, OUT_RTOL, flat_decode, parity, pool_decode

    saved = dict(LAUNCHES)
    L, Hkv, Tcap, D = pool.k_tail.shape
    scale = D ** -0.5
    dev = pool.row_head.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    pk, pv = pool.k_tail.clone(), pool.v_tail.clone()
    fk, fv = flat.k_tail.clone(), flat.v_tail.clone()
    if int4:
        pargs = (pool.k_pool_q, pool.k_pool_s, pool.k_pool_z, pool.v_pool_q, pool.v_pool_s,
                 pool.v_pool_z)
        fargs = (flat.k_flat_q, flat.k_flat_s, flat.k_flat_z, flat.v_flat_q, flat.v_flat_s,
                 flat.v_flat_z)
    else:
        pargs, fargs = (pool.k_pool, pool.v_pool), (flat.k_flat, flat.v_flat)
    meta = (pool.row_head, pool.layer_off, pool.layer_rows)
    worst = dict(flat_vs_plain=0.0, pool_vs_plain=0.0)
    stats = dict(max_flat_minus_pool=0.0)
    if int4:
        worst.update(flat_q8_vs_plain=0.0, pool_q8_vs_plain=0.0)
        stats.update(flat_q8_rel_rms=[], pool_q8_rel_rms=[])
    for T in (1, 16):
        for l in range(L):
            q = torch.randn(T, num_heads, D, generator=gen, device=dev).to(torch.bfloat16)
            kn = torch.randn(Hkv, T, D, generator=gen, device=dev).to(torch.bfloat16)
            vn = torch.randn(Hkv, T, D, generator=gen, device=dev).to(torch.bfloat16)
            pk[l, :, :T], pv[l, :, :T], fk[l, :, :T], fv[l, :, :T] = kn, vn, kn, vn
            if int4:
                want = pool_decode.pool_decode_attend_int4_plain(
                    q.float(), *pargs, *meta, pk.float(), pv.float(), 0, l, scale=scale)
                got_p = pool_decode.pool_decode_attend_int4(
                    q, *pargs, *meta, pk, pv, 0, l, scale=scale, max_rows=pool.max_rows)
                got_f = flat_decode.flat_decode_attend_int4(
                    q, *fargs, flat.row_head, fk[l], fv[l], 0, scale=scale, layer=l)
            else:
                want = pool_decode.pool_decode_attend_plain(
                    q.float(), *pargs, *meta, pk.float(), pv.float(), 0, l, scale=scale)
                got_p = pool_decode.pool_decode_attend(
                    q, *pargs, *meta, pk, pv, 0, l, scale=scale, max_rows=pool.max_rows)
                got_f = flat_decode.flat_decode_attend(
                    q, *fargs, flat.row_head, fk[l], fv[l], 0, scale=scale, layer=l)
            checks = [("flat_vs_plain", got_f, want, None), ("pool_vs_plain", got_p, want, None)]
            if int4:
                want8, slack8 = pool_decode.pool_decode_attend_int4_plain(
                    q.float(), *pargs, *meta, pk.float(), pv.float(), 0, l, scale=scale,
                    q8=True, with_slack=True)
                got_p8 = pool_decode.pool_decode_attend_int4(
                    q, *pargs, *meta, pk, pv, 0, l, scale=scale, max_rows=pool.max_rows,
                    q8=True)
                got_f8 = flat_decode.flat_decode_attend_int4(
                    q, *fargs, flat.row_head, fk[l], fv[l], 0, scale=scale, q8=True, layer=l)
                checks += [("pool_q8_vs_plain", got_p8, want8, slack8)]
                # the flat layout tiles its segment from row 0 of the layer,
                # the pool from layer_off: the same rows, the same tiles
                checks += [("flat_q8_vs_plain", got_f8, want8, slack8)]
                stats["pool_q8_rel_rms"].append(rel_rms(got_p8, got_p))
                stats["flat_q8_rel_rms"].append(rel_rms(got_f8, got_f))
            for key, got, ref, slack in checks:
                r = parity(got, ref, OUT_RTOL, slack)
                if not r["ok"]:
                    raise AssertionError(f"cross-layout attention T={T} layer {l} {key}: {r}")
                worst[key] = max(worst[key], r["worst_to_tol"])
            stats["max_flat_minus_pool"] = max(stats["max_flat_minus_pool"],
                                               (got_f.float() - got_p.float()).abs().max().item())
    LAUNCHES.update(saved)
    for key in ("pool_q8_rel_rms", "flat_q8_rel_rms"):
        if key in stats:
            v = stats.pop(key)
            stats[key] = dict(mean=sum(v) / len(v), max=max(v))
    stats["worst_to_tol"] = worst
    log(phase="cross_layout_attention", int4=int4, layers=L, T=[1, 16], **stats)
    return stats


def windowed_pass(weng, eng, ctx_ids):
    """One prefill of ctx_ids, scored exactly (``eng``) and windowed
    (``weng``, the same parameters with ``scoring_attend="window"``): both
    scoring times, the Pearson correlation of the two scores (all layers,
    and layer by layer) and the share of (layer, head, token) entries on
    which their pair keep masks at ratio 0.3 agree. Reported, and asserted
    only finite; layer 0, whose queries and keys the window does not
    change, must score identically in both modes."""
    import numpy as np
    import torch

    from kvzip_tpu_torch.prune import prune_mask

    st = weng.prefill(ctx_ids, do_score=False)
    _, exact_s = timed(lambda: eng.scoring(st, st.ctx_ids))
    exact = st.score.clone()
    _, window_s = timed(lambda: weng.scoring(st, st.ctx_ids))
    window = st.score
    if window.shape != exact.shape or not torch.isfinite(window).all():
        raise AssertionError(f"bad windowed scores: {tuple(window.shape)}")
    if not torch.equal(window[0], exact[0]):
        raise AssertionError("layer 0 scores differ between exact and windowed scoring")
    w, e = (s.double().flatten(1).cpu().numpy() for s in (window, exact))
    corr = float(np.corrcoef(w.ravel(), e.ravel())[0, 1])
    per_layer = [float(np.corrcoef(a, b)[0, 1]) for a, b in zip(w, e)]
    keep_w, keep_e = (prune_mask(s, 0.3, "pair", method="histogram")[0]
                      for s in (window, exact))
    agree = float((keep_w == keep_e).float().mean())
    if not (np.isfinite(corr) and np.isfinite(agree)):
        raise AssertionError(f"windowed scores: correlation {corr}, agreement {agree}")
    return dict(exact_scoring_s=exact_s, window_scoring_s=window_s, score_pearson=corr,
                score_pearson_per_layer=per_layer, keep_mask_agreement=agree, keep_share_window=float(keep_w.float().mean()),
                keep_share_exact=float(keep_e.float().mean()))


# ------------------------------------------------------------------ serving
SERVE_CTX = 8192
SERVE_RATIOS = (0.3, 0.4, 0.5, 0.6)  # per-layer rows differ between requests


class IdsTokenizer:
    """Decodes an answer to its ids, so that the scheduler's answers
    compare token for token (the byte tokenizer drops ids >= 256)."""

    def decode(self, ids, skip_special_tokens=True):
        import numpy as np

        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


def serving_states(engines: dict, ctxs) -> dict:
    """Each context prefilled and scored once by the first engine, then
    pruned by every engine (pool, flat) at its ratio, each from its own copy
    of the scored state: {name: states}."""
    out = {name: [] for name in engines}
    first = next(iter(engines.values()))
    for ctx, ratio in zip(ctxs, SERVE_RATIOS):
        st = first.prefill(ctx)
        for i, (name, e) in enumerate(engines.items()):
            s = st if i == len(engines) - 1 else dataclasses.replace(
                st, cache=copy.deepcopy(st.cache), score=st.score.clone())
            e.prune(s, ratio, "pair")
            out[name].append(s)
    return out


def own_schedule(eng, st, query, ans):
    """Logits (len(query) + len(ans), V) along state st's own schedule:
    the query in the engine's chunks (as ``generate_ids`` ingests it), then
    each answer token alone (what its captured ``DecodeStep`` replays);
    the state restored."""
    import numpy as np

    from kvzip_tpu_torch.cache import restore, snapshot

    snap = snapshot(st.cache)
    out = [eng.forward_ids(query, st, update_cache=True, return_logits=True)] if len(query) else []
    out += [eng.forward_ids(ans[i:i + 1], st, update_cache=True, return_logits=True)
            for i in range(len(ans))]
    restore(st.cache, snap)
    return np.concatenate(out)


def hold_merged(phase, eng, states, queries, singles, gots, alone=False):
    """The merged decode step held against each state's own step on the
    same tokens: teacher-forced logits along each request's single-state
    answer, the queries through the merged stack in one padded pass and
    each answer token a forward (``batched_logits(ingest=...)``: the
    stack ``MergedDecodeStep`` captures, on ``batched_generate``'s
    schedule), beside each state's own schedule (``own_schedule``). With
    ``alone`` (continuous batching's schedule) each query goes through its
    state's own chunks on both sides and only the answers through the
    merged stack. Its launches count with the phase's. Two controls on the
    same state and tokens: the merged stack at B = 1 (held within twice
    the single path's schedule noise, its chunks against its tokens on the
    first request), and a batch of B copies of the state, which changes
    only the batch shape (the linears at B times the rows, the copies'
    rows one after another in the merged cache) and carries no other
    sequence's context: its largest distance from the state's own logits,
    or the schedule noise where that is larger, is the request's floor.
    ``hold_logits`` holds the merged difference within twice the floor,
    the argmax wherever the margin is clear and the merged answer ``gots``
    up to the first near-tie. In the int8-attention mode every side runs
    q8. Returns each request's floors, difference and logit scale."""
    import numpy as np

    from kvzip_tpu_torch import serving
    from kvzip_tpu_torch.cache import restore, snapshot

    B = len(states)
    if alone and len({id(st) for st in states}) != B:
        raise ValueError("hold_merged(alone=True) ingests each state once: states must differ")
    full = np.concatenate([queries[0], singles[0]])
    noise = float(np.abs(teacher_forced(eng, states[0], full, step=False)
                         - teacher_forced(eng, states[0], full, step=True)).max())
    snaps = [snapshot(st.cache) for st in states]
    if alone:  # the queries ingested alone, the same rows on both sides
        heads = [eng.forward_ids(q, st, update_cache=True, return_logits=True)
                 for q, st in zip(queries, states)]
        seqs, ingest = [np.asarray(a) for a in singles], [0] * B
        n_q = [0] * B
    else:
        heads = [np.zeros((0, 0), np.float32)] * B
        seqs = [np.concatenate([q, a]) for q, a in zip(queries, singles)]
        ingest = n_q = [len(q) for q in queries]

    def merged(sts, ss, ks):
        return serving.batched_logits(eng, ss, sts, ingest=ks)

    def joined(head, tail):
        return np.concatenate([head, tail]) if head.size else tail

    l_merged = merged(states, seqs, ingest)
    out = []
    for b, (st, q, want, got) in enumerate(zip(states, queries, singles, gots)):
        seq, head = seqs[b], heads[b]
        l_single = joined(head, own_schedule(eng, st, seq[:n_q[b]], seq[n_q[b]:]))
        one = joined(head, merged([st], [seq], ingest[b:b + 1])[0])
        hold_logits(f"{phase}_batch1_{b}", l_single, l_single, one, True, q, want, want,
                    floor=noise)
        copies = merged([st] * B, [seq] * B, [ingest[b]] * B)
        control = max(float(np.abs(joined(head, c) - l_single).max()) for c in copies)
        batch1 = float(np.abs(one - l_single).max())
        stats = hold_logits(f"{phase}_step_{b}", l_single, l_single,
                            joined(head, l_merged[b]), True, q, want, np.asarray(got),
                            floor=max(noise, control), schedule_noise=noise,
                            batch1_control=batch1, copies_control=control)
        out.append(dict(floor=stats["noise_floor"], schedule_noise=noise, batch1_control=batch1,
                        copies_control=control, max_logit_diff=stats["max_logit_diff"],
                        logit_absmax=stats["logit_absmax"]))
    for st, snap in zip(states, snaps):
        restore(st.cache, snap)
    return out


def device_used() -> int:
    """Device memory in use, the allocator's cache emptied first (a graph's
    private pool stays: it is held while its graph lives)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return total - free


def serving_path(eng, states, queries, tally, attn: str):
    """Batched serving over B pruned states (``serving.batched_generate_ids``,
    one merged cache, one captured step for the batch) against each state's
    own captured decode (``generate_ids``). Holds: in the merged call every
    launch is ``attn`` once a layer a merged forward (the ingest and each
    step; for W4A8 also K8 four times a layer, at T = B rows on the steps),
    and no other kernel (no K12, K13, K14, no kernel of another layout or
    mode); the merged step against each state's own on the same tokens
    (``hold_merged``, every request); every state's counters are back at
    their snapshot, and its next answer is its first. Reports the merged
    step's host-clock ms (t(31 steps) - t(1 step)) / 30 of
    ``MergedBatch.decode`` on one ingested batch) and device ms (CUDA
    events around 20 replays of its graph), each also divided by B, beside
    the sum of the B states' own decode ms/token (``generate_ids``, host
    clock, and ``step_device_ms``); ``batched_generate_ids``' seconds
    beside the B states' own ``generate_ids`` seconds (the same queries and
    budget, their steps captured before) and the seconds of a merge
    (``MergedBatch``) and of a capture, which every call pays; the memory
    the merged and the single-state graphs hold (``device_used`` growth
    around their captures); the merged cache's bytes (``mem_bytes``)
    beside the states'."""
    import numpy as np
    import torch

    from kvzip_tpu_torch import ops, serving
    from kvzip_tpu_torch.cache import restore, snapshot
    from kvzip_tpu_torch.ops import LAUNCHES

    L, B = eng.config.num_layers, len(states)
    rep = {}
    snaps = [snapshot(st.cache) for st in states]
    used = device_used()
    singles = [eng.generate_ids(q, st) for q, st in zip(queries, states)]
    rep["single_graphs_bytes"] = device_used() - used
    host, dev, gen_s = [], [], []
    for q, st in zip(queries, states):
        ans, t_long = timed(lambda: eng.generate_ids(q, st))
        ans2, t_short = timed(lambda: eng.generate_ids(q, st, max_new_tokens=2))
        host.append((t_long - t_short) / (len(ans) - len(ans2)) * 1e3)
        gen_s.append(t_long)
        dev.append(step_device_ms(eng, st))
    rep.update(single_ms_per_token=host, single_sum_ms=sum(host), single_device_ms=dev,
               single_device_sum_ms=sum(dev), single_generate_s=gen_s,
               single_generate_sum_s=sum(gen_s))

    l0, t0 = dict(LAUNCHES), dict(tally)
    gots, rep["batched_generate_s"] = timed(
        lambda: serving.batched_generate_ids(eng, queries, states, max_new_tokens=NEW_TOKENS))
    launched = {k: v - l0.get(k, 0) for k, v in LAUNCHES.items() if v != l0.get(k, 0)}
    counts = {k: v - t0.get(k, 0) for k, v in tally.items() if v != t0.get(k, 0)}
    fwd = counts.get("merged_forwards", 0)
    steps = fwd - 1
    want = {attn: L * fwd} if attn else {}
    if "w4a8_matmul_stacked_v2" in launched:
        want["w4a8_matmul_stacked_v2"] = 4 * L * fwd
        if counts.get(f"serving w4a8 T {B}", 0) != 4 * L * steps:
            raise AssertionError(f"K8 at T = {B}: {counts} over {steps} merged steps")
    if attn and attn.startswith("flat") and counts.get(f"{attn} n_seq {B}", 0) != L * fwd:
        raise AssertionError(f"{attn} not once a layer at n_seq {B}: {counts}")
    rep.update(merged_forwards=fwd, merged_launches=launched, merged_tally=counts)
    if launched != want:
        raise AssertionError(f"merged launches {launched}, want {want} ({fwd} merged forwards)")
    for st, snap in zip(states, snaps):
        if any(not torch.equal(getattr(st.cache, f), v) for f, v in snap.items()):
            raise AssertionError("a state's counters are not back at their snapshot")
    rep["held"] = hold_merged(f"serving_{attn or 'dense'}", eng, states, queries, singles, gots)
    if not np.array_equal(eng.generate_ids(queries[0], states[0]), singles[0]):
        raise AssertionError("a state's answer changed after the merged batch")
    rep.update(answers_equal=[bool(np.array_equal(a, g)) for a, g in zip(singles, gots)],
               answer_tokens=[g.tolist() for g in gots])

    # the merged step alone, on one ingested batch (no launch counted)
    saved = ops.counts_snapshot()
    batch, rep["merge_s"] = timed(lambda: serving.MergedBatch(eng, states))
    batch.check_room(24 + NEW_TOKENS)
    first = batch.ingest(queries)
    snap = snapshot(batch.cache)
    used = device_used()
    step = batch.decode_step()
    rep.update(capture_s=batch.capture_s, merged_graph_bytes=device_used() - used)
    per = {}
    for n in (1, NEW_TOKENS - 1, 1):
        restore(batch.cache, snap)
        (_, k), secs = timed(lambda: batch.decode(first, n))
        per[n] = (secs, k)
    step_ms = (per[NEW_TOKENS - 1][0] - per[1][0]) / (per[NEW_TOKENS - 1][1] - per[1][1]) * 1e3
    step.done.fill_(1)
    dev_ms = time_ms(lambda: step.graph.replay(), 20)
    ops.counts_restore(saved)
    rep.update(merged_step_ms=step_ms, merged_ms_per_token=step_ms / B,
               merged_step_device_ms=dev_ms, merged_device_ms_per_token=dev_ms / B,
               merged_mem_bytes=batch.cache.mem_bytes(),
               states_mem_bytes=[st.cache.mem_bytes() for st in states])
    del batch, step
    return rep


def continuous_path(eng, states, queries, tally):
    """``Scheduler.run_continuous(segment=8)``: six requests over the B
    pool states at ``max_batch`` B, budgets such that requests retire in
    different rounds and queued ones are admitted mid-flight (a request
    whose state is busy waits). Each request is held against its state's
    own ``generate_ids`` with the same budget by ``hold_merged``, the six
    in batches of B in submission order; every state restored. Reports
    each round (batch, admissions, capture seconds)."""
    import numpy as np

    from kvzip_tpu_torch import serving

    reqs = [(0, 8), (1, 16), (2, 24), (3, 32), (0, 16), (1, 8)]  # (state, max_new_tokens)
    ieng = copy.copy(eng)
    ieng.tokenizer = IdsTokenizer()
    B = len(states)
    sched = serving.Scheduler(ieng, max_batch=B)
    for i, (s, mn) in enumerate(reqs):
        sched.submit(queries[i], states[s], max_new_tokens=mn)
    got, secs = timed(lambda: sched.run_continuous(segment=8))
    got = [np.asarray([int(t) for t in g.split()], np.int64) for g in got]
    singles = [eng.generate_ids(queries[i], states[s], max_new_tokens=mn)
               for i, (s, mn) in enumerate(reqs)]
    sts = [states[s] for s, _ in reqs]
    held = []
    for i in range(0, len(reqs), B):
        held += hold_merged(f"serving_continuous_{i // B}", eng, sts[i:i + B],
                            queries[i:i + B], singles[i:i + B], got[i:i + B], alone=True)
    if not any(r["admitted"] for r in sched.rounds[1:]):
        raise AssertionError(f"no request admitted mid-flight: {sched.rounds}")
    if any(int(st.cache.tail_len) or int(st.cache.seen) != st.prefill_len for st in states):
        raise AssertionError("a state was not restored after the continuous run")
    return dict(seconds=secs, rounds=sched.rounds, held=held,
                answers_equal=[bool(np.array_equal(a, g)) for a, g in zip(singles, got)])


# ------------------------------------------------- the dense routes (retain,
# compaction, head-level zero-copy eviction, the masked route)
def dense_kernel_parity(cache, num_heads: int, tag: str):
    """The dense-cache kernels at the shapes a compacted or head-evicted
    cache gives them (its heads' lengths far apart): K4 (T 1, 8) and K1 (T
    16, 24, 64) on a bf16 cache, K5's decode form (T 1, 4) on an int4 one,
    at its first and last layers, the T new rows written at each head's
    length in a copy of the layer; each held by ``ops.parity`` against its
    plain version. Its launches are not counted."""
    import torch

    from kvzip_tpu_torch.ops import LAUNCHES, OUT_RTOL, flash, flash_int4, parity, ragged_decode
    from kvzip_tpu_torch.ops.quant import quantize_int4

    saved = dict(LAUNCHES)
    int4 = hasattr(cache, "k_q")
    L, Hkv, C = cache.lengths.shape[0], cache.lengths.shape[1], cache.capacity
    D = 128
    dev = cache.lengths.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    worst = {}
    for l in (0, L - 1):
        lens = cache.lengths[l]
        for T in ((1, 4) if int4 else (1, 8, 16, 24, 64)):
            q = rn(T, num_heads, D)
            if int4:
                layer = [a[l].clone() for a in (cache.k_q, cache.k_s, cache.k_z, cache.v_q,
                                                 cache.v_s, cache.v_z)]
                for i in (0, 3):
                    p, s_, z = quantize_int4(rn(Hkv, T, D), pack="split")
                    for h, n in enumerate(lens.tolist()):
                        layer[i][h, n:n + T], layer[i + 1][h, n:n + T] = p[h], s_[h, :, 0]
                        layer[i + 2][h, n:n + T] = z[h, :, 0]
                got = flash_int4.flash_attend_int4(q, *layer, lens, scale=D ** -0.5)
                want = flash_int4.flash_attend_int4_plain(q.float(), *layer, lens,
                                                          scale=D ** -0.5)
                name = "flash_attend_int4_decode"
            else:
                kd, vd = cache.k[l].clone(), cache.v[l].clone()
                for h, n in enumerate(lens.tolist()):
                    kd[h, n:n + T], vd[h, n:n + T] = rn(T, D), rn(T, D)
                kern = ragged_decode.ragged_decode_attend if T <= 8 else flash.flash_attend
                name = kern.__name__
                got = kern(q, kd, vd, lens, scale=D ** -0.5)
                want = ragged_decode.ragged_decode_attend_plain(q.float(), kd.float(), vd.float(),
                                                                lens, scale=D ** -0.5)
            r = parity(got, want, OUT_RTOL)
            if not r["ok"]:
                raise AssertionError(f"{tag}: {name} T={T} layer {l} on lengths "
                                     f"{lens.tolist()}: {r}")
            worst[f"{name} T {T}"] = max(worst.get(f"{name} T {T}", 0.0), r["worst_to_tol"])
    LAUNCHES.update(saved)
    log(phase=f"{tag}_kernel_parity", capacity=C, lengths_min=int(cache.lengths.min()),
        lengths_max=int(cache.lengths.max()), worst_to_tol=worst)
    return worst


def no_launches(what: str, fn):
    """fn()'s result; fails if it launched any kernel (the masked route
    runs torch ops only)."""
    from kvzip_tpu_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    out = fn()
    ran = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
    if ran:
        raise AssertionError(f"{what} launched kernels: {ran}")
    return out


def retain_path(reng, eng, ceng, ctx_ids, queries, keep):
    """``Engine(kv_type="retain")``: one prefill and scoring (K1, K2: the
    unpruned retain cache takes the kernels), then prune at pair 0.3, 0.6
    and 1.0 on the same state, three queries each through the captured
    step over the masked route (``attn_impl`` "blockwise" above 4,096 rows
    a head), which must launch no kernel; ms/token host clock and device
    beside the pool's (the main path's, ``keep["pool_ms"]``), the per-token
    loop's at 0.3 only (its answers held equal to the step's there). Holds: at
    0.3, a copy of the scored state compacted (``flat_decode="off"``,
    ``ceng``) keeps the same rows per head and its teacher-forced logits
    (K1/K4) stay within twice the retain state's schedule noise
    (``allkept_check``); at 1.0, against a copy of the unpruned state
    (K1/K4). The retain and compacted states stay in ``keep``."""
    import torch

    rep = {}
    st, rep["prefill_s"] = timed(lambda: reng.prefill(ctx_ids, do_score=False))
    _, rep["scoring_s"] = timed(lambda: reng.scoring(st, st.ctx_ids))

    def evict_copy():
        return dataclasses.replace(st, kv_type="evict", cache=copy.deepcopy(st.cache),
                                   score=st.score.clone())

    unpruned, compacted = evict_copy(), evict_copy()
    for ratio in (0.3, 0.6, 1.0):
        (_, kept), secs = timed(lambda: reng.prune(st, ratio, "pair"))
        ms, answers = no_launches("retain decode", lambda: decode_ms_per_token(
            reng, st, queries, eager=ratio == 0.3))
        rep[f"pair_{ratio}"] = dict(prune_s=secs, kept_ratio=kept, attn_impl=reng._impl(st),
                                    ms_per_token=ms, answer_tokens=[a.tolist() for a in answers])
        if ratio == 0.3:
            _, rep["compact_prune_s"] = timed(lambda: ceng.prune(compacted, 0.3, "pair"))
            rows = st.cache.valid[:, :, :st.prefill_len].sum(-1).to(torch.int32)
            if not torch.equal(rows, compacted.cache.lengths):
                raise AssertionError("retain 0.3 keeps other rows than the compaction")
            rep["vs_compact"] = allkept_check(reng, st, compacted, queries[0], answers[0],
                                              full_eng=ceng, phase="retain_vs_compact")
        elif ratio == 1.0:
            if not st.cache.valid.all():
                raise AssertionError("retain 1.0 masked a row")
            ans = eng.generate_ids(queries[0], unpruned)
            rep["vs_unpruned"] = allkept_check(eng, unpruned, st, queries[0], ans, full_eng=reng,
                                               phase="retain_vs_unpruned")
    rep["pool_ms_per_token"] = keep["pool_ms"]
    rep["kv_bytes_allocated"] = dict(retain=st.cache.mem_bytes(),
                                     compact=compacted.cache.mem_bytes())
    keep.update(retain=st, compact=compacted)
    return rep


def compact_path(ceng, st, queries, quant: bool):
    """The dense compaction (``flat_decode="off"``) of a scored state at pair
    0.3 (pruned here unless it is already): the kernels at its shapes
    (``dense_kernel_parity``), then the three queries with no eos stop
    (32 tokens each), whose launches must be exactly the ladder's: bf16 K1
    once a layer a query chunk of more than 8 rows, K4 once a layer a
    shorter chunk and a decode step; int4 K5 once a layer a chunk and a
    step, in its decode form at 16 rows or fewer; no other attention
    kernel. Then ms/token (host clock, device)."""
    import numpy as np

    from kvzip_tpu_torch.engine import ladder_split
    from kvzip_tpu_torch.ops import LAUNCHES

    rep = {}
    if not st.pruned:
        _, rep["prune_s"] = timed(lambda: ceng.prune(st, 0.3, "pair"))
    cache = st.cache
    rep.update(capacity=cache.capacity, kv_bytes_pruned=int(cache.used_bytes()),
               kv_bytes_allocated=cache.mem_bytes(), attn_impl=ceng._impl(st))
    rep["kernel_parity"] = dense_kernel_parity(cache, ceng.config.num_heads,
                                               "compact_quant" if quant else "compact")
    neng = copy.copy(ceng)
    neng.eos_ids = (-1,)
    L, steps = ceng.config.num_layers, NEW_TOKENS - 1
    before = dict(LAUNCHES)
    for q in queries:
        if len(neng.generate_ids(q, st)) != NEW_TOKENS:
            raise AssertionError("an answer with no eos stopped early")
    got = {k: v - before[k] for k, v in LAUNCHES.items()
           if v != before[k] and k not in ("w4a8_matmul_stacked_v2",)}
    chunks = [c for q in queries for c in ladder_split(len(q))]
    big = sum(c > (16 if quant else 8) for c in chunks)
    small = len(chunks) - big + steps * len(queries)
    want = (dict(flash_attend_int4=L * (big + small), flash_attend_int4_decode=L * small)
            if quant else dict(flash_attend=L * big, ragged_decode_attend=L * small))
    want = {k: v for k, v in want.items() if v}
    rep.update(launches_exact=got, launches_want=want)
    if got != want:
        raise AssertionError(f"compacted decode launched {got}, want {want}")
    rep["ms_per_token"], answers = decode_ms_per_token(ceng, st, queries)
    rep["answer_tokens"] = [np.asarray(a).tolist() for a in answers]
    return rep


def head_path(heng, reng, ctx_ids, queries, keep):
    """The head-level zero-copy eviction: the retain state's own scores
    saved as head scores (``prune.save_head_score``, each head's maximum)
    in a temporary directory, two prefills of the context with
    ``load_score=True`` (no scoring), one pruned at head 0.6 by ``heng``
    (evict, ``flat_decode="off"``: dropped heads' lengths set to the
    sink, the K and V buffers kept), one by the retain engine. Holds: no
    row moved, each head keeps the whole context or none, the kernels at
    its lengths (``dense_kernel_parity``), and its teacher-forced logits
    (K1/K4) within twice the retain state's schedule noise
    (``allkept_check``). ms/token of both."""
    import shutil
    import tempfile

    import torch

    from kvzip_tpu_torch import prune as prune_lib

    rep = {}
    tmp = tempfile.mkdtemp()
    try:
        prune_lib.save_head_score(keep.pop("retain").score, heng.name, "smoke", 0, out_dir=tmp)
        hst, rep["prefill_s"] = timed(lambda: heng.prefill(ctx_ids, load_score=True,
                                                           head_score_dirs=[tmp]))
        rst = reng.prefill(ctx_ids, load_score=True, head_score_dirs=[tmp])
    finally:
        shutil.rmtree(tmp)
    k_buf, live = hst.cache.k, hst.cache.used_bytes()
    (_, kept), rep["prune_s"] = timed(lambda: heng.prune(hst, 0.6, "head"))
    reng.prune(rst, 0.6, "head")
    ctx_rows = set((hst.cache.lengths - hst.sink).unique().tolist())
    if hst.cache.k is not k_buf or not ctx_rows <= {0, hst.ctx_len}:
        raise AssertionError(f"head prune moved rows or kept part of a head: {ctx_rows}")
    rows = rst.cache.valid[:, :, :rst.prefill_len].sum(-1).to(torch.int32)
    if not torch.equal(rows, hst.cache.lengths):
        raise AssertionError("the head-level evict keeps other rows than retain")
    rep.update(kept_ratio=kept, heads_kept=int((hst.cache.lengths > hst.sink).sum()),
               kv_bytes_live=[int(live), int(hst.cache.used_bytes())])
    rep["kernel_parity"] = dense_kernel_parity(hst.cache, heng.config.num_heads, "head")
    rep["ms_per_token"], answers = decode_ms_per_token(heng, hst, queries)
    rep["retain_ms_per_token"], r_answers = no_launches(
        "retain decode", lambda: decode_ms_per_token(reng, rst, queries, eager=False))
    rep["held"] = allkept_check(reng, rst, hst, queries[0], r_answers[0], full_eng=heng,
                                phase="head_vs_retain")
    return rep


def state_io(eng, st, queries):
    """``save_state`` of the main path's pruned pool into a temporary
    directory, ``load_state`` into a fresh state: every array and counter
    equal, the same answer; seconds and bytes of each side."""
    import tempfile

    import numpy as np
    import torch

    rep = {}
    with tempfile.TemporaryDirectory() as d:
        path, rep["save_s"] = timed(lambda: eng.save_state(st, os.path.join(d, "pool")))
        rep["file_bytes"] = os.path.getsize(path) + os.path.getsize(path[:-4] + ".json")
        got, rep["load_s"] = timed(lambda: eng.load_state(path))
    for f in ("k_pool", "v_pool", "row_head", "layer_off", "layer_rows", "k_tail", "v_tail",
              "lengths", "tail_lens", "seen"):
        if not torch.equal(getattr(got.cache, f), getattr(st.cache, f)):
            raise AssertionError(f"loaded pool differs in {f}")
    want = eng.generate_ids(queries[0], st)
    ans = eng.generate_ids(queries[0], got)
    if not np.array_equal(ans, want):
        raise AssertionError(f"loaded state answers {ans.tolist()}, saved {want.tolist()}")
    rep.update(mem_bytes=got.cache.mem_bytes(), answer_tokens=ans.tolist())
    return rep


def llama1b_path(eng, ctx_ids, queries):
    """``llama3.2-1b`` (head_dim 64, which no kernel takes): the engine
    routes every attention to the masked route (``_impl``: "blockwise"),
    and a pair 0.3 evict prune compacts (``_use_flat`` False), as the
    reference does. Prefill, scoring, prune, three queries; the phase must
    launch no kernel. Holds: finite non-negative scores of the context's
    shape; "dense" against "blockwise" (the same attention, other blocks)
    teacher-forced within twice the schedule noise (``allkept_check``)."""
    import torch

    cfg = eng.config
    rep = {}
    st, rep["prefill_s"] = timed(lambda: eng.prefill(ctx_ids, do_score=False))
    rep["attn_impl_prefill"] = eng._impl(st)
    _, rep["scoring_s"] = timed(lambda: eng.scoring(st, st.ctx_ids))
    score = st.score
    if score.shape != (cfg.num_layers, cfg.num_kv_heads, len(ctx_ids)) \
            or not torch.isfinite(score).all() or not (score >= 0).all():
        raise AssertionError(f"bad scores: {tuple(score.shape)}")
    rep["kv_bytes_dense"] = int(st.cache.used_bytes())
    (_, kept), rep["prune_s"] = timed(lambda: eng.prune(st, 0.3, "pair"))
    if type(st.cache).__name__ != "KVCache":
        raise AssertionError(f"llama3.2-1b pruned into {type(st.cache).__name__}")
    rep.update(kept_ratio=kept, capacity=st.cache.capacity, attn_impl=eng._impl(st),
               kv_bytes_pruned=int(st.cache.used_bytes()))
    rep["ms_per_token"], answers = decode_ms_per_token(eng, st, queries)
    deng = copy.copy(eng)
    deng.attn_impl = "dense"
    ans = deng.generate_ids(queries[0], st)
    rep["dense_vs_blockwise"] = allkept_check(deng, st, st, queries[0], ans, full_eng=eng,
                                              phase="llama1b_dense_vs_blockwise")
    rep["answer_tokens"] = [a.tolist() for a in answers]
    return rep


# ----------------------------------------------------- qwen3 and gemma3
QWEN3_MODEL = "qwen3-8b"
GEMMA3_MODEL = "gemma3-4b"
FAMILY_CTX = 4096  # serving_qwen3's states, the ring hold's and the v1 path's context


def gemma3_path(eng, ctx_ids, queries):
    """gemma3-4b over the hybrid cache (``HybridKV``, retain; the masked
    route on its five static layers, ``attend_ring`` on its 29 sliding
    ones; no kernel may launch): prefill and scoring seconds (the sliding
    layers' scores must be zero), static and ring bytes, the snapshot's
    copy (the rings whole) in ms, the three queries' answers unpruned;
    holds: a second generate of a query on the state gives its first
    answer (the rings restored), retain 1.0 gives the unpruned answers;
    then pair 0.3 on the static layers and decode ms/token (captured host
    clock, device, per-token loop; the two loops' answers equal)."""
    import numpy as np
    import torch

    from kvzip_tpu_torch.cache import HybridKV, snapshot

    cfg = eng.config
    rep = {}
    st, rep["prefill_s"] = timed(lambda: eng.prefill(ctx_ids, do_score=False))
    _, rep["scoring_s"] = timed(lambda: eng.scoring(st, st.ctx_ids))
    cache = st.cache
    sliding = [l for l in range(cfg.num_layers) if l not in cfg.static_layer_ids]
    score = st.score
    if not isinstance(cache, HybridKV) or eng.kv_type != "retain" \
            or score.shape != (cfg.num_layers, cfg.num_kv_heads, len(ctx_ids)) \
            or not torch.isfinite(score).all() or score[sliding].any():
        raise AssertionError(f"bad hybrid state or scores: {type(cache).__name__} "
                             f"{tuple(score.shape)}")
    W = cache.window
    if cache.k_ring.shape != (len(sliding), cfg.num_kv_heads, W, cfg.head_dim) \
            or W != -(-cfg.sliding_window // 128) * 128 or int(cache.ring_pos.min()) < 0:
        raise AssertionError(f"rings {tuple(cache.k_ring.shape)}, window {W}")
    rep.update(attn_impl=eng._impl(st), static_layers=list(cfg.static_layer_ids),
               static_kv_bytes=cache.mem_bytes() - cache.ring_bytes(),
               ring_bytes=cache.ring_bytes(), kv_bytes_live=int(cache.used_bytes()))
    rep["snapshot_ms"] = time_ms(lambda: snapshot(cache), 10)
    unpruned = [eng.generate_ids(q, st) for q in queries]
    if not np.array_equal(eng.generate_ids(queries[0], st), unpruned[0]):
        raise AssertionError("a second generate of one query on one state gave another answer")
    (_, kept), _ = timed(lambda: eng.prune(st, 1.0, "pair"))
    full = [eng.generate_ids(q, st) for q in queries]
    if kept != 1.0 or any(not np.array_equal(a, b) for a, b in zip(full, unpruned)):
        raise AssertionError("retain 1.0 answers other than the unpruned state")
    (_, kept), rep["prune_s"] = timed(lambda: eng.prune(st, 0.3, "pair"))
    ctx_rows = cache.valid[:, :, st.sink:st.prefill_len]
    rep.update(kept_ratio=kept, static_rows_kept=int(ctx_rows.sum()),
               static_rows=int(ctx_rows.numel()))
    rep["ms_per_token"], answers = decode_ms_per_token(eng, st, queries)
    rep["unpruned_answer_tokens"] = [a.tolist() for a in unpruned]
    rep["answer_tokens"] = [a.tolist() for a in answers]
    return rep


def gemma3_window_hold(eng, ctx_ids, queries, keep):
    """The ring against the dense window at full width: a FAMILY_CTX-token
    context (four wraps of the 1,024-row ring) in the hybrid cache, each
    query's last-position logits against the port's plain forward of the
    same weights over a dense cache with the window mask
    (``transformer.forward``, "blockwise"), in three schedules: the context
    in one chunk and the query in one, the context in chunks of 512 and the
    query a token a forward, the context in chunks of 1,024 and the query
    in one. Their largest pairwise difference is the noise floor (logits of
    matmuls of other shapes and attention summed in another order); the
    hybrid must stay within twice it. Held twice: in bf16 (the engine's
    hybrid state, ``forward_ids``), and in float32 (the same weights cast
    to float32, ``forward_hybrid`` and ``forward`` called directly: the
    masked route and ``attend_ring`` are torch ops), where the floor is
    the float32 summation order alone, so the hold is tight where the bf16
    one is not. Then the bf16 state is pruned at pair 0.3 and answers the
    queries (``keep["answers"]``, for the v1 path)."""
    import numpy as np
    import torch

    from kvzip_tpu_torch.cache import init_cache, init_hybrid_cache, restore, snapshot
    from kvzip_tpu_torch.models.hybrid import forward_hybrid
    from kvzip_tpu_torch.models.transformer import forward

    cfg = eng.config
    st = eng.prefill(ctx_ids)
    W = st.cache.window
    if st.prefill_len < 4 * W or int(st.cache.ring_pos.min()) != st.prefill_len - W:
        raise AssertionError("the ring did not wrap four times")
    ids = torch.as_tensor(np.asarray(st.prefill_ids, np.int64), device=eng.device)
    qts = [torch.as_tensor(q.astype(np.int64), device=eng.device) for q in queries]
    cap = -(-(len(ids) + 64) // 512) * 512

    def last_logits(fwd, params, cache, ctx_chunk, query_step):
        for a in range(0, len(ids), ctx_chunk):
            fwd(params, cfg, ids[a:a + ctx_chunk], cache, attn_impl="blockwise")
        snap, out = snapshot(cache), []
        for qt in qts:
            parts = [qt[i:i + 1] for i in range(len(qt))] if query_step else [qt]
            for part in parts:
                last = fwd(params, cfg, part, cache, collect_logits="last",
                           attn_impl="blockwise").logits
            out.append(last[-1].float().cpu().numpy())
            restore(cache, snap)
        return np.stack(out)

    def hold(tag, params, dtype, hybrid):
        runs = [last_logits(forward, params, init_cache(cfg, cap, dtype, eng.device), c, step)
                for c, step in ((len(ids), False), (512, True), (1024, False))]
        floor = max(float(np.abs(x - y).max()) for i, x in enumerate(runs) for y in runs[i + 1:])
        diff = float(np.abs(hybrid - runs[0]).max())
        r = dict(noise_floor=floor, max_logit_diff=diff, logit_absmax=float(np.abs(runs[0]).max()),
                 argmax_equal=[bool(x) for x in hybrid.argmax(-1) == runs[0].argmax(-1)])
        log(phase=f"gemma3_ring_vs_dense_{tag}", ctx=len(ctx_ids), wraps=st.prefill_len / W, **r)
        if not np.isfinite(hybrid).all() or diff > 2 * floor:
            raise AssertionError(f"ring against dense window ({tag}): {diff} > 2 x {floor}")
        return r

    rep = dict(ctx_tokens=len(ctx_ids), wraps=st.prefill_len / W)
    rep["bf16"] = hold("bf16", eng.params, eng.dtype, np.stack(
        [eng.forward_ids(q, st, return_logits=True)[-1] for q in queries]))
    p32 = {k: (v.float() if torch.is_tensor(v) else {n: w.float() for n, w in v.items()})
           for k, v in eng.params.items()}
    h32 = last_logits(forward_hybrid, p32, init_hybrid_cache(cfg, cap, torch.float32, eng.device),
                      len(ids), False)
    rep["float32"] = hold("float32", p32, torch.float32, h32)
    del p32
    eng.prune(st, 0.3, "pair")
    keep["answers"] = [eng.generate_ids(q, st) for q in queries]
    rep["answer_tokens"] = [x.tolist() for x in keep["answers"]]
    return rep


def kernel_parity_k16_rows(cfg, tree, rows=(1, 2304, FAMILY_CTX)):
    """K16 (``w4a8_matmul``) on layer 0 of gemma3-4b's v1 tree, each of its
    seven linears (q 2560 -> 2048, k/v 2560 -> 1024, o 2048 -> 2560,
    gate/up 2560 -> 10240, down 10240 -> 2560) against its plain version
    at T 1 (a decode step), 2,304 (the scoring pass) and FAMILY_CTX (the
    v1 path's largest prefill chunk), the gate rejecting one input group
    dropped at T 1; each T's seven linears timed (``kernel_ms`` cycling
    over the 34 layers, so that at T 1 the weights come from device
    memory, summed)
    beside their bound (the weight bytes of the true groups plus x and out
    over 3.35 TB/s, against 2 T IN OUT int8 operations). Launches are not
    counted."""
    import torch

    from kvzip_tpu_torch.ops import LAUNCHES, OUT_RTOL, w4a8

    saved = dict(LAUNCHES)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    checks, per_t = {}, {}
    cycle = iter(range(10 ** 9))
    D, I, att = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    shapes = dict(wq=(D, att), wk=(D, kv), wv=(D, kv), wo=(att, D), w_gate=(D, I),
                  w_up=(D, I), w_down=(I, D))
    for T in rows:
        tot = dict(ms=0.0, host_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
        for n, (IN, OUT) in shapes.items():
            stack = tree["layers"][n]
            wl = {k: v[0] for k, v in stack.items()}
            x = torch.randn(T, IN, generator=gen, device="cuda").to(torch.bfloat16)
            got = w4a8.w4a8_matmul(x, wl["q4"], wl["s"], wl["z"])
            want = w4a8._w4a8_jnp(x.float(), wl)
            drop = None
            if T == 1:
                xd = x.float().clone()
                xd[:, 128:256] = 0
                drop = w4a8._w4a8_jnp(xd, wl)
            hold_parity(checks, "w4a8_matmul", f"gemma3 {n} {IN}->{OUT} T {T}", got, want,
                        OUT_RTOL, drop)
            nbytes = IN * OUT // 2 + 2 * 2 * (IN // 128) * OUT + 2 * T * (IN + OUT)
            b = bound(2 * T * IN * OUT, nbytes, PEAK_INT8_OPS)
            slices = [[stack[k][i] for k in ("q4", "s", "z")] for i in range(len(stack["q4"]))]
            r = kernel_ms(lambda: w4a8.w4a8_matmul(x, *slices[next(cycle) % len(slices)]),
                          2 * len(slices) if T == 1 else 3)
            tot["ms"] += r["ms"]
            tot["host_ms"] += r["host_ms"]
            tot["bound_ms"] += b[0]
            tot["ops_ms"] += 2 * T * IN * OUT / PEAK_INT8_OPS * 1e3
            tot["bytes_ms"] += nbytes / PEAK_BYTES * 1e3
        tot["bound_by"] = "operations" if tot["ops_ms"] > tot["bytes_ms"] else "bytes"
        per_t[f"T {T}"] = tot
    LAUNCHES.update(saved)
    log(phase="k16_gemma3_rows", **per_t)
    return per_t, checks


def gemma3_v1_path(veng, ctx_ids, queries, bf16_answers):
    """The v1 W4A8 tree of the bf16 engine's weights (``weight_quant=
    "none"``: every projection of ``forward_hybrid`` through K16, seven a
    layer) over a FAMILY_CTX-token context: prefill and scoring seconds;
    K16's launches in one single-token forward, which must be 7 x 34; pair
    0.3 and the three queries, decode ms/token, and the answers' token
    agreement with the bf16 hybrid's on the same context and prune."""
    from kvzip_tpu_torch.ops import LAUNCHES

    rep = {}
    st, rep["prefill_s"] = timed(lambda: veng.prefill(ctx_ids, do_score=False))
    _, rep["scoring_s"] = timed(lambda: veng.scoring(st, st.ctx_ids))
    before = LAUNCHES["w4a8_matmul"]
    veng.forward_ids(queries[0][:1], st)
    rep["k16_launches_per_forward"] = LAUNCHES["w4a8_matmul"] - before
    if rep["k16_launches_per_forward"] != 7 * veng.config.num_layers:
        raise AssertionError(f"K16 ran {rep['k16_launches_per_forward']} times in one "
                             f"{veng.config.num_layers}-layer forward")
    veng.prune(st, 0.3, "pair")
    rep["ms_per_token"], answers = decode_ms_per_token(veng, st, queries)
    same, first = token_agreement(answers, bf16_answers)
    rep.update(token_agreement=same, first_mismatch=first,
               answer_tokens=[a.tolist() for a in answers])
    return rep


def family_paths(counted, tally, kernels, flat_kernels, no_fused) -> dict:
    """The qwen3 and gemma3 phases (``qwen3_path``, ``serving_qwen3``,
    ``gemma3_path``, ``gemma3_window_hold``, ``gemma3_v1_path``), each
    through ``counted``; K16's gemma3 rows folded into its kernels-line row.
    Returns the phases' launches for the kernels line."""
    import numpy as np
    import torch

    from kvzip_tpu_torch.config import resolve_config
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.models.params import quantize_layer_stacks
    from kvzip_tpu_torch.ops import LAUNCHES
    from kvzip_tpu_torch.ops.w4a8 import quantize_weight_int4

    # the qwen3 family (qk-norm, on the kernels' route): qwen3-8b at full
    # width through the main path, then two of its states merged
    family_launches = {}
    cfg = resolve_config(QWEN3_MODEL)
    eng = Engine(QWEN3_MODEL, config=cfg, dtype=torch.bfloat16, device="cuda",
                 max_new_tokens=NEW_TOKENS, seed=SEED)
    rng = np.random.default_rng(SEED)
    ctx_ids = rng.integers(0, cfg.vocab_size, CTX).astype(np.int32)
    queries = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32) for _ in range(3)]
    add_launches(family_launches, counted(
        "qwen3_path", eng, ("flash_attend", "fused_scores", "ragged_decode_attend",
                            "pool_decode_attend"), main_path, ctx_ids, queries,
        absent=flat_kernels))
    sv = serving_states({"pool": eng}, [rng.integers(0, cfg.vocab_size, FAMILY_CTX)
                                        .astype(np.int32) for _ in range(2)])
    add_launches(family_launches, counted(
        "serving_qwen3", eng, ("pool_decode_attend",), serving_path, sv["pool"], queries[:2],
        tally, "pool_decode_attend", absent=(*flat_kernels, *no_fused)))
    del sv, eng
    gc.collect()
    torch.cuda.empty_cache()

    # gemma3 over the hybrid ring cache (retain, the masked route: no
    # kernel), then its v1 W4A8 tree (every projection through K16)
    cfg = resolve_config(GEMMA3_MODEL)
    eng = Engine(GEMMA3_MODEL, config=cfg, dtype=torch.bfloat16, device="cuda",
                 max_new_tokens=NEW_TOKENS, seed=SEED)
    rng = np.random.default_rng(SEED)
    ctx_ids = rng.integers(0, cfg.vocab_size, CTX).astype(np.int32)
    queries = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32) for _ in range(3)]
    ctx_small = rng.integers(0, cfg.vocab_size, FAMILY_CTX).astype(np.int32)
    counted("gemma3_path", eng, (), gemma3_path, ctx_ids, queries, absent=tuple(LAUNCHES))
    keep = {}
    counted("gemma3_window_hold", eng, (), gemma3_window_hold, ctx_small, queries, keep,
            absent=tuple(LAUNCHES))
    v1_tree = dict(eng.params, layers=quantize_layer_stacks(eng.params["layers"],
                                                            quantize_weight_int4))
    k16_rows, k16_checks = kernel_parity_k16_rows(cfg, v1_tree)
    veng = Engine(GEMMA3_MODEL, config=cfg, params=v1_tree, tokenizer=eng.tokenizer,
                  dtype=torch.bfloat16, device="cuda", max_new_tokens=NEW_TOKENS)
    del eng
    gc.collect()
    v1_counts = counted("gemma3_v1_path", veng, ("w4a8_matmul",), gemma3_v1_path, ctx_small,
                        queries, keep["answers"],
                        absent=tuple(n for n in LAUNCHES if n != "w4a8_matmul"))
    if v1_counts["w4a8_matmul"] % (7 * cfg.num_layers):
        raise AssertionError(f"K16 launched {v1_counts['w4a8_matmul']} times on the v1 path, "
                             f"not 7 x {cfg.num_layers} a forward")
    family_launches["w4a8_matmul"] = v1_counts["w4a8_matmul"]
    k16_row = next(r for r in kernels if r["name"] == "w4a8_matmul")
    fold_parity(k16_row, k16_checks)
    k16_row["gemma3_rows"] = k16_rows
    del veng, v1_tree, keep
    gc.collect()
    torch.cuda.empty_cache()
    log(phase="family_launches", **family_launches)
    return family_launches


# ----------------------------------------------------------- the CLI
CLI_MODEL = "llama3.2-3b"  # the command line's default model
CLI_CTX = 16384
CLI_QUANT = ("--kv_quant", "int4", "--weight_quant", "w4a8", "--embed_quant", "int8")


class _Tee(io.TextIOBase):
    """Text written to it goes to stderr and is kept (the command line's
    output: stdout keeps the smoke's own lines)."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        sys.stderr.write(text)
        return len(text)


def cli_run(argv) -> Tuple[str, float]:
    """``kvzip_tpu_torch.cli.main(argv)`` in-process, in the current working
    directory: its output (sent to stderr too) and its host-clock seconds
    (synchronized); the card's cache emptied after."""
    import torch

    from kvzip_tpu_torch import cli

    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        _, secs = timed(lambda: cli.main(list(argv)))
    gc.collect()
    torch.cuda.empty_cache()
    return "".join(tee.parts), secs


def _stamps(out: str):
    """The TimeStamp lines' times, in order."""
    return [float(x) for x in re.findall(r"## Time: ([0-9.]+)m?s\.", out)]


def _demo_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith('{"demo"')]
    if not lines:
        raise AssertionError("the demo printed no JSON line")
    return json.loads(lines[-1])["demo"]


def cli_test(_, work: str):
    """``cli test -m llama3.2-3b -d squad --ratio 0.3 --save_head_score``:
    prefill, scoring, the full-cache answers on the dense cache and their
    probabilities, the head scores saved, prune 0.3 into the pool, the
    pruned answers and their comparison. Holds: the head-score file
    written, of (layers, kv heads). Reports the TimeStamp seconds."""
    import numpy as np

    from kvzip_tpu_torch.config import resolve_config

    os.chdir(work)
    out, secs = cli_run(["test", "-m", CLI_MODEL, "-d", "squad", "--ratio", "0.3",
                         "--save_head_score"])
    path = os.path.join(work, "head_score", f"{CLI_MODEL}-squad-0.npz")
    cfg = resolve_config(CLI_MODEL)
    head = np.load(path)["score"]
    if head.shape != (cfg.num_layers, cfg.num_kv_heads) or not np.isfinite(head).all():
        raise AssertionError(f"head scores of shape {head.shape}")
    return dict(command_s=secs, stamps_s=_stamps(out),
                synthetic_data="synthetic stand-in" in out)


def _canary_table(out: str) -> dict:
    rows = out.split("ratio avg_performance")[1].split()
    return {float(r): float(v) for r, v in zip(rows[::2], rows[1::2])}


def golden_at_full(argv) -> dict:
    """The golden compare at retain 1.0 on the needle sample the sweep ran:
    an engine the command line would build (``make_engine``, the same
    weights), the sample's full-cache answer and probabilities (as
    ``DataWrapper.generate_answer`` makes them, K4 and K1 on the unpruned
    cache, the answer's ids kept as generated), then
    prune at 1.0 and ``Evaluator(..., generate=False)`` (the masked route).
    Held with ``retain_path``'s rule for retain 1.0 against the unpruned
    state: the probability differences within twice the schedule noise
    (the unpruned state's probabilities in chunks against token by token),
    and a flipped argmax only where the full cache's top two are within
    the largest difference."""
    import numpy as np
    import torch

    from kvzip_tpu_torch import cli
    from kvzip_tpu_torch.data import DataWrapper, get_query, load_dataset_all
    from kvzip_tpu_torch.eval import Evaluator
    from kvzip_tpu_torch.utils import set_gen_length

    args = cli.build_parser().parse_args(argv)
    args.kv_type = "retain"  # as cmd_eval
    eng = cli.make_engine(args)
    data = DataWrapper(args.data, load_dataset_all(args.data, eng.tokenizer), eng)
    set_gen_length(args.data, eng)
    st = data.prefill_context(args.idx)
    # DataWrapper.generate_answer's inputs, with the answer's ids as
    # generated: random weights answer in ids the byte tokenizer cannot
    # spell, so its text round trip would leave no answer token to compare
    rec = data.dataset[args.idx]
    q_ids = eng.apply_template(get_query("qa", rec["question"][0]))
    a_ids = eng.generate_ids(q_ids, st)
    seq, n = np.concatenate([q_ids, a_ids]), len(a_ids)
    p_full = eng.prob(seq, st)
    steps = torch.softmax(torch.from_numpy(teacher_forced(eng, st, seq, step=True)), -1)
    floor = float(np.abs(steps.numpy() - p_full)[-n - 1:-1].max())
    _, kept = eng.prune(st, 1.0, args.level)
    if not st.cache.valid.all():
        raise AssertionError("retain 1.0 masked a row")
    inputs = {"qa": {"q": q_ids, "a": a_ids, "gt": eng.encode(rec["answers"][0])}}
    r = Evaluator(eng, inputs, {"qa": {"prob": p_full}})(st, generate=False)["qa"]
    diff = max(abs(r["p"][0]), abs(r["p"][2]), abs(r["p_ans"][0]), abs(r["p_ans"][2]))
    top2 = np.sort(p_full[-n - 1:-1], axis=-1)[:, -2:]
    near = np.nonzero(top2[:, 1] - top2[:, 0] <= diff)[0].tolist()
    rep = dict(kept_ratio=kept, answer_tokens=n, noise_floor=floor, max_prob_diff=diff,
               p=r["p"], p_ans=r["p_ans"], margin=r["margin"], flips=r["idx_flip"],
               near_ties=len(near), attn_impl=eng._impl(st))
    if diff > 2 * floor:
        raise AssertionError(f"golden compare at 1.0: probabilities differ by {diff} > "
                             f"2 x {floor}")
    if set(r["idx_flip"]) - set(near):
        raise AssertionError(f"golden compare at 1.0: argmax flipped at a clear margin "
                             f"({r['idx_flip']}, near-ties {near})")
    return rep


def cli_eval(_, work: str):
    """``cli eval -m llama3.2-3b -d needle --num 1`` (a retain prefill of the
    first needle sample, the full-cache answer, then prune at nine ratios
    and answer after each: the masked route), its result file (nine ratio
    rows); the same sweep with ``--canary`` and ``parse`` of it (the
    reference's parse globs on the model name, so the tagged folder is read
    as ``llama3.2-3b__canary``): 100.00 at 1.00 and never rising as the
    ratio falls; then the golden compare at retain 1.0 (``golden_at_full``)."""
    os.chdir(work)
    argv = ["eval", "-m", CLI_MODEL, "-d", "needle", "--num", "1"]
    rep = {}
    out, rep["eval_s"] = cli_run(argv)
    with open(os.path.join(work, "results", "needle", f"0_{CLI_MODEL}", "output-pair.json")) as f:
        rows = json.load(f)["qa"]
    if [r[0][0] for r in rows] != [0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1]:
        raise AssertionError(f"eval wrote ratio rows {[r[0] for r in rows]}")
    rep.update(kept=[r[0][1] for r in rows], stamps_s=_stamps(out),
               distinct_answers=len({r[1]["pruned"] for r in rows}))
    _, rep["canary_s"] = cli_run(argv + ["--canary"])
    out, _ = cli_run(["parse", "-m", f"{CLI_MODEL}__canary", "-d", "needle"])
    table = _canary_table(out)
    scores = [table[r] for r in sorted(table, reverse=True)]
    rep["canary_table"] = {f"{r:.2f}": v for r, v in sorted(table.items(), reverse=True)}
    if len(table) != 10 or scores[0] != 100.0 or scores != sorted(scores, reverse=True):
        raise AssertionError(f"canary table {table}: not 100.00 at 1.00 and non-increasing")
    with contextlib.redirect_stdout(_Tee()):  # the harness's output to stderr
        rep["golden_at_full"], rep["golden_s"] = timed(lambda: golden_at_full(argv))
    return rep


def cli_demo(_, work: str, extra=(), modes=("kvzip", "kvzip_head"), model=None):
    """``cli demo --model <model> --ctx_tokens 16384 --baseline`` in each
    mode (``kvzip_head`` with the head scores ``cli_test`` saved): the
    demo's JSON line parses and the pruned cache is smaller than the dense
    one; the demo's GB and ms/token, full and pruned."""
    os.chdir(work)
    rep = {}
    for mode in modes:
        argv = ["demo", "--model", model or CLI_MODEL, "--ctx_tokens", str(CLI_CTX), "--baseline",
                "-m", mode, *extra]
        if mode == "kvzip_head":
            argv += ["--head_score_dir", os.path.join(work, "head_score")]
        out, secs = cli_run(argv)
        demo = _demo_line(out)
        if not demo["pruned_gb"] < demo["full_gb_dense"]:
            raise AssertionError(f"demo {mode}: pruned {demo['pruned_gb']} GB is not below "
                                 f"the dense {demo['full_gb_dense']} GB")
        rep[mode] = dict(demo, command_s=secs, stamps_ms=_stamps(out))
    return rep


def add_launches(launches: dict, counts: dict) -> None:
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "kvzip_tpu_torch")):
        sys.exit("chip_smoke.py runs from a checkout of the repository "
                 "(kvzip_tpu_torch/ not found)")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the smoke run needs one card")
    sys.path.insert(0, HERE)
    from kvzip_tpu_torch import _build
    from kvzip_tpu_torch import engine as engine_module
    from kvzip_tpu_torch.cache import FlatInt4KV, FlatKV
    from kvzip_tpu_torch.config import resolve_config
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.models import transformer as transformer_module
    from kvzip_tpu_torch import ops
    from kvzip_tpu_torch import serving as serving_module
    from kvzip_tpu_torch.ops import LAUNCHES, reset_launches
    from kvzip_tpu_torch.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(phase="build", seconds=time.perf_counter() - t0,
        ptxas=[ln.strip() for lg in build_logs.values() for ln in lg.splitlines()
               if "registers" in ln])
    log(phase="build_wgmma", **hopper_build_report(_build, build_logs))

    cfg = resolve_config(MODEL)
    t0 = time.perf_counter()
    eng = Engine(MODEL, config=cfg, dtype=torch.bfloat16, device="cuda",
                 max_new_tokens=NEW_TOKENS, seed=SEED)
    torch.cuda.synchronize()
    log(phase="init", seconds=time.perf_counter() - t0)
    rng = np.random.default_rng(SEED)
    ctx_ids = rng.integers(0, cfg.vocab_size, CTX).astype(np.int32)
    queries = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32) for _ in range(3)]
    sink = len(eng.sys_prompt_ids)
    capacity = -(-(sink + CTX + max(eng.score_q_pad, eng.decode_budget))
                 // eng.capacity_granularity) * eng.capacity_granularity

    t0 = time.perf_counter()
    kernels = kernel_parity(cfg, CTX, sink, capacity, eng.decode_budget)
    kernels_q = kernel_parity_int4(cfg, CTX, sink, capacity, eng.decode_budget)
    kernels_f = kernel_parity_flat(cfg, CTX, sink, eng.decode_budget)
    kernels_k12 = kernel_parity_fused(cfg)
    kernels_v1 = kernel_parity_w4a8_v1(cfg)
    tp_checks = kernel_parity_tp_local(cfg, sink, capacity, eng.decode_budget)
    for r in kernels + kernels_q:
        if r["name"] in tp_checks:
            fold_parity(r, {r["name"]: tp_checks[r["name"]]})
    log(phase="kernel_parity", seconds=time.perf_counter() - t0,
        timing_details=[{k: v for k, v in r.items()
                         if k in ("name", "ms", "host_ms", "library_ms", "bound_ms",
                                  "deq_k1_ms", "k1_ms", "padded_bound_ms", "exp_floor_ms",
                                  "per_shape")}
                        for r in kernels + kernels_q + kernels_f + kernels_k12 + kernels_v1])

    # The smoke's own counts, beside LAUNCHES in ops.COUNTS, so that a
    # replayed decode step adds to them as its captured calls would: every
    # forward over a flat cache ("flat_forwards") and K13's and K14's
    # calls by their rows ("rmsnorm_quant T 1", ...), counted for the
    # whole run by wrappers around engine.forward and the two functions
    # in the forward's module.
    tally = {}
    ops.COUNTS.append(tally)
    forward = engine_module.forward

    def counting_forward(params, cfg_, ids, cache, **fkw):
        if isinstance(cache, (FlatKV, FlatInt4KV)):
            tally["flat_forwards"] = tally.get("flat_forwards", 0) + 1
        return forward(params, cfg_, ids, cache, **fkw)

    def tallied(module, name, key):
        """module.name counted in the tally under key(its arguments)."""
        real = getattr(module, name)

        def call(*args, **kw):
            k = key(*args, **kw)
            tally[k] = tally.get(k, 0) + 1
            return real(*args, **kw)
        setattr(module, name, call)

    engine_module.forward = counting_forward
    for n in ("rmsnorm_quant", "silu_mul_quant"):
        tallied(transformer_module, n, lambda x, *a, _n=n, **kw: f"{_n} T {x.shape[0]}")
    # the serving module's merged forwards, K10/K11 calls by n_seq and W4A8
    # linears by rows, counted the same way
    tallied(serving_module, "_stack_forward", lambda *a, **kw: "merged_forwards")
    for n in ("flat_decode_attend", "flat_decode_attend_int4"):
        tallied(serving_module, n,
                lambda *a, _n=n, **kw: f"{_n}{'_q8' if kw.get('q8') else ''} n_seq {kw['n_seq']}")
    tallied(serving_module, "w4a8_linear_stacked",
            lambda x, *a, **kw: f"serving w4a8 T {x.shape[0]}")

    def counted(tag, engine, kernel_names, path, *args, absent=(), per_flat_layer=None, **kw):
        """One path between a counter reset and a read; every kernel of the
        path must have launched, and none of ``absent``. ``per_flat_layer``:
        a kernel that must launch exactly once a layer of each forward over
        a flat cache (the forwards counted at ``engine.forward``). The
        smoke's tallies over the path are returned in ``rep["tally"]``."""
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        before = dict(tally)
        t0 = time.perf_counter()
        rep = path(engine, *args, **kw)
        seconds = time.perf_counter() - t0
        counts = {k: v - before.get(k, 0) for k, v in tally.items() if v != before.get(k, 0)}
        flat_forwards = counts.pop("flat_forwards", 0)
        launches = {n: LAUNCHES[n] for n in (*kernel_names, *absent)}
        log(phase=tag, model=engine.name, layers=engine.config.num_layers, ctx=CTX, **rep,
            launches=launches, flat_forwards=flat_forwards, tally=counts,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, phase_s=seconds)
        missing = [n for n in kernel_names if launches[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {tag}: {missing}")
        stray = [n for n in absent if launches[n]]
        if stray:
            raise AssertionError(f"kernels of another layout or mode ran on the {tag}: {stray}")
        if per_flat_layer is not None and \
                launches[per_flat_layer] != engine.config.num_layers * flat_forwards:
            raise AssertionError(
                f"{per_flat_layer} launched {launches[per_flat_layer]} times on the {tag}, not "
                f"once a layer of its {flat_forwards} flat forwards")
        counts.update({n: launches[n] for n in kernel_names})
        return counts

    def run(tag, engine, kernel_names, **kw):
        return counted(tag, engine, kernel_names, main_path, ctx_ids, queries, **kw)

    def variant(engine, **options):
        """The same engine (parameters, tokenizer) with other options."""
        e = copy.copy(engine)
        for k, v in options.items():
            setattr(e, k, v)
        return e

    pool_kernels = ("pool_decode_attend", "pool_decode_attend_int4",
                    "pool_decode_attend_int4_q8")
    flat_kernels = ("flat_decode_attend", "flat_decode_attend_int4",
                    "flat_decode_attend_int4_q8")
    keep = {}
    launches = run("main_path", eng, ("flash_attend", "fused_scores",
                                      "ragged_decode_attend", "pool_decode_attend"),
                   absent=flat_kernels, keep=keep)
    feng = variant(eng, flat_decode="legacy")
    launches.update(counted("flat_path", feng, ("flat_decode_attend",), flat_path, keep,
                            queries, False, absent=pool_kernels,
                            per_flat_layer="flat_decode_attend"))
    cross_layout_attention(keep["pool"].cache, keep["flat"].cache, cfg.num_heads, int4=False)
    allkept_check(eng, keep["pool"], keep["flat"], queries[0], keep["answers"][0],
                  full_eng=feng, phase="cross_layout_logits")
    # the dense routes: retain, the compaction, the head-level zero-copy
    # eviction (the masked route launches nothing), the state file
    reng = variant(eng, kv_type="retain")
    ceng = variant(eng, flat_decode="off")
    every_kernel = tuple(LAUNCHES)
    layouts = (*pool_kernels, *flat_kernels)
    # K1 and K2 on the prefill and scoring, K4 (and K1) on the holds' compacted
    # and unpruned copies; the retain decodes themselves launch nothing
    add_launches(launches, counted("retain_path", reng,
                                   ("flash_attend", "fused_scores", "ragged_decode_attend"),
                                   retain_path, eng, ceng, ctx_ids, queries, keep,
                                   absent=layouts))
    add_launches(launches, counted("compact_path", ceng, ("flash_attend", "ragged_decode_attend"),
                                   compact_path, keep.pop("compact"), queries, False,
                                   absent=(*layouts, "fused_scores")))
    add_launches(launches, counted("head_path", ceng, ("flash_attend", "ragged_decode_attend"),
                                   head_path, reng, ctx_ids, queries, keep,
                                   absent=(*layouts, "fused_scores")))
    add_launches(launches, counted("state_io", eng, ("pool_decode_attend",), state_io,
                                   keep["pool"], queries, absent=flat_kernels))
    # tensor parallelism: the same path through Engine(mesh=...) over NCCL
    mesh, world = init_tp_group()
    if world == 1:
        teng = Engine(MODEL, config=cfg, params=eng.params, tokenizer=eng.tokenizer,
                      dtype=torch.bfloat16, device="cuda", max_new_tokens=NEW_TOKENS, mesh=mesh)
        add_launches(launches, counted("tp_path", teng, ("flash_attend", "fused_scores",
                                                         "ragged_decode_attend",
                                                         "pool_decode_attend"),
                                       tp_path, eng, ctx_ids, queries, keep, world,
                                       absent=flat_kernels))
        del teng
        import torch.distributed as dist
        dist.destroy_process_group()
    else:  # one process a card; rank 0's launches join the line
        rep = tp_ranks(world, ctx_ids, queries, keep)
        log(phase="tp_path", **rep)
        tp_launches = {n: rep["launches"][n] for n in ("flash_attend", "fused_scores",
                                                       "ragged_decode_attend",
                                                       "pool_decode_attend")}
        if not all(tp_launches.values()):
            raise AssertionError(f"kernels never launched on the tp_path: {tp_launches}")
        add_launches(launches, tp_launches)
    # batched serving: four contexts pruned at four ratios, merged
    del keep
    gc.collect()
    t0 = time.perf_counter()
    serve_ctxs = [rng.integers(0, cfg.vocab_size, SERVE_CTX).astype(np.int32) for _ in range(4)]
    serve_q = queries + [rng.integers(0, cfg.vocab_size, 24).astype(np.int32) for _ in range(3)]
    sv = serving_states({"flat": feng, "pool": eng}, serve_ctxs)
    log(phase="serving_states", seconds=time.perf_counter() - t0, ctx=SERVE_CTX,
        ratios=SERVE_RATIOS)
    no_fused = ("w4a8_layer_fused", "rmsnorm_quant", "silu_mul_quant")
    add_launches(launches, counted(
        "serving_pool", eng, ("pool_decode_attend",), serving_path, sv["pool"], serve_q[:4],
        tally, "pool_decode_attend", absent=(*flat_kernels, *no_fused)))
    add_launches(launches, counted(
        "serving_flat", feng, ("flat_decode_attend",), serving_path, sv["flat"], serve_q[:4],
        tally, "flat_decode_attend", absent=(*pool_kernels, *no_fused)))
    add_launches(launches, counted(
        "serving_continuous", eng, ("pool_decode_attend",), continuous_path, sv["pool"],
        serve_q, tally, absent=(*flat_kernels, *no_fused)))
    del sv
    # four retain states on the same contexts: the dense batch path (the
    # masked route over 4 x Hkv heads, no kernel)
    sv = serving_states({"retain": reng}, serve_ctxs)
    add_launches(launches, counted("serving_dense", reng, (), serving_path, sv["retain"],
                                   serve_q[:4], tally, None, absent=every_kernel))
    del sv, reng, ceng
    for r in kernels + kernels_f:
        r["launches"] = launches.get(r["name"], 0)
    del eng, feng
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    eng = Engine(MODEL, config=cfg, dtype=torch.bfloat16, device="cuda",
                 max_new_tokens=NEW_TOKENS, seed=SEED, **QUANT)
    torch.cuda.synchronize()
    log(phase="init_quant", seconds=time.perf_counter() - t0, **QUANT)
    keep = {}
    launches = run("main_path_quant", eng,
                   ("fused_scores", "flash_attend_int4", "flash_attend_int4_decode",
                    "flash_attend_int4_extra", "pool_decode_attend_int4",
                    "w4a8_matmul_stacked_v2"),
                   absent=("pool_decode_attend_int4_q8", *flat_kernels), quant=True, keep=keep)
    scored_q = dataclasses.replace(keep["scored"], cache=copy.deepcopy(keep["scored"].cache),
                                   score=keep["scored"].score.clone())
    feng = variant(eng, flat_decode="legacy")
    launches.update(counted("flat_path_quant", feng, ("flat_decode_attend_int4",), flat_path,
                            keep, queries, True,
                            absent=("flat_decode_attend_int4_q8", *pool_kernels),
                            per_flat_layer="flat_decode_attend_int4"))
    pool_st, flat_st = keep["pool"], keep["flat"]
    add_launches(launches, counted(
        "compact_path_quant", variant(eng, flat_decode="off"),
        ("flash_attend_int4", "flash_attend_int4_decode", "w4a8_matmul_stacked_v2"),
        compact_path, scored_q, queries, True,
        absent=("flash_attend", "ragged_decode_attend", *pool_kernels, *flat_kernels)))
    del scored_q
    qfeng = variant(feng, attn_quant="int8")
    launches.update(counted(
        "flat_path_quant_q8", qfeng, ("flat_decode_attend_int4_q8",), q8_path, flat_st,
        queries, keep["flat_answers"],
        lambda: qfeng.synthetic_full_flat_state(flat_st, True, qfeng.decode_budget),
        absent=("flat_decode_attend_int4", *pool_kernels),
        per_flat_layer="flat_decode_attend_int4_q8"))
    qpeng = variant(eng, attn_quant="int8")
    launches.update(counted(
        "pool_path_quant_q8", qpeng, ("pool_decode_attend_int4_q8",), q8_path, pool_st,
        queries, keep["answers"],
        lambda: qpeng.synthetic_full_pool_state(pool_st, True, qpeng.decode_budget),
        absent=("pool_decode_attend_int4", *flat_kernels)))
    # the fused W4A8 decode layer (K12) on the same pool state
    fpeng = variant(eng, fuse_layer="on")
    fused_launches = counted(
        "fused_layer_quant", fpeng,
        ("w4a8_layer_fused", "w4a8_matmul_stacked_v2", "pool_decode_attend_int4"), fused_path,
        eng, pool_st, queries, keep["answers"],
        lambda: eng.synthetic_full_pool_state(pool_st, True, eng.decode_budget),
        absent=("pool_decode_attend_int4_q8", *flat_kernels))
    launches["w4a8_layer_fused"] = fused_launches["w4a8_layer_fused"]
    # the v1 W4A8 storage (K15) and the int4 lm_head (K8 on the vocabulary)
    # on the tree the flagship draws before its repack, the same state
    from kvzip_tpu_torch.models.params import init_params_w4a8

    v1_tree = init_params_w4a8(cfg, torch.Generator("cuda").manual_seed(SEED), "cuda",
                               torch.bfloat16)
    veng = Engine(MODEL, config=cfg, params=v1_tree, tokenizer=eng.tokenizer,
                  dtype=torch.bfloat16, device="cuda", max_new_tokens=NEW_TOKENS, **V1)
    v1_absent = ("w4a8_matmul_stacked_v2", "w4a8_layer_fused", "w4a8_matmul",
                 "pool_decode_attend_int4_q8", *flat_kernels)
    # the v1 path's K2/K5-K7 counts stay in its own log line: the kernels
    # line keeps the flagship's; K16 (absent here) is on no Engine path of
    # the port (only _lin takes a per-layer v1 dict), so its count is 0
    counted("v1_path_quant", veng, ("w4a8_matmul_stacked", "fused_scores", "flash_attend_int4",
                                    "flash_attend_int4_extra", "pool_decode_attend_int4"),
            v1_path, ctx_ids, queries, absent=v1_absent)
    launches.update({n: LAUNCHES[n] for n in ("w4a8_matmul_stacked", "w4a8_matmul")})
    v1_vs_v2(veng, eng, pool_st, queries, keep["answers"])
    heng = Engine(MODEL, config=cfg, params=v1_tree, tokenizer=eng.tokenizer,
                  dtype=torch.bfloat16, device="cuda", max_new_tokens=NEW_TOKENS,
                  **dict(V1, embed_quant="int4h"))
    head_checks = {}
    counted("int4h_head", heng, ("w4a8_matmul_stacked_v2", "w4a8_matmul_stacked",
                                 "pool_decode_attend_int4"), int4h_path, veng, pool_st,
            queries, head_checks, absent=v1_absent[1:])
    fold_parity(next(r for r in kernels_q if r["name"] == "w4a8_matmul_stacked_v2"),
                head_checks)
    del v1_tree, veng, heng
    q8_logits(feng, qfeng, flat_st, queries, keep["flat_answers"], "q8_logits_flat")
    q8_logits(eng, qpeng, pool_st, queries, keep["answers"], "q8_logits_pool")
    cross_layout_attention(pool_st.cache, flat_st.cache, cfg.num_heads, int4=True)
    allkept_check(eng, pool_st, flat_st, queries[0], keep["answers"][0], full_eng=feng,
                  phase="cross_layout_logits_quant")
    # batched serving on the int4 pool: exact attention, then int8
    t0 = time.perf_counter()
    sv = serving_states({"pool": eng}, serve_ctxs)
    log(phase="serving_states_quant", seconds=time.perf_counter() - t0)
    q8_kernels = ("pool_decode_attend_int4_q8", "flat_decode_attend_int4_q8")
    add_launches(launches, counted(
        "serving_quant", eng, ("pool_decode_attend_int4", "w4a8_matmul_stacked_v2"),
        serving_path, sv["pool"], serve_q[:4], tally, "pool_decode_attend_int4",
        absent=(*q8_kernels, *flat_kernels, *no_fused)))
    add_launches(launches, counted(
        "serving_quant_q8", qpeng, ("pool_decode_attend_int4_q8",), serving_path, sv["pool"],
        serve_q[:4], tally, "pool_decode_attend_int4_q8",
        absent=("pool_decode_attend_int4", *flat_kernels, *no_fused)))
    del sv
    # K5's forms: the wrapper counts every launch, the decode form also apart
    launches["flash_attend_int4"] -= launches["flash_attend_int4_decode"]
    if not launches["flash_attend_int4"]:
        raise AssertionError("K5's prefill form never launched on the quantized path")
    for r in kernels_q + kernels_f + kernels_k12 + kernels_v1:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]
    kernels += kernels_q + kernels_k12 + kernels_v1
    del eng, feng, qfeng, qpeng, fpeng, keep, pool_st, flat_st
    gc.collect()
    torch.cuda.empty_cache()
    checkpoint_load(ByteTokenizer(CKPT_CONFIG["vocab_size"]))

    # the W8A8-KV4 path at llama3.1-8b, its own context and queries
    cfg = resolve_config(W8_MODEL)
    t0 = time.perf_counter()
    eng = Engine(W8_MODEL, config=cfg, dtype=torch.bfloat16, device="cuda",
                 max_new_tokens=NEW_TOKENS, seed=SEED, **W8)
    weng = Engine(W8_MODEL, config=cfg, params=eng.params, tokenizer=eng.tokenizer,
                  dtype=torch.bfloat16, device="cuda", max_new_tokens=NEW_TOKENS,
                  scoring_attend="window", **W8)
    torch.cuda.synchronize()
    log(phase="init_w8a8", seconds=time.perf_counter() - t0, model=W8_MODEL, **W8)
    rng = np.random.default_rng(SEED)
    ctx_ids = rng.integers(0, cfg.vocab_size, CTX).astype(np.int32)
    queries = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32) for _ in range(3)]

    t0 = time.perf_counter()
    kernels_w8 = kernel_parity_w8a8(cfg, len(eng.sys_prompt_ids))
    log(phase="kernel_parity_w8a8", seconds=time.perf_counter() - t0,
        timing_details=[{k: v for k, v in r.items() if k in ("name", "ms", "host_ms",
                                                             "library_ms", "per_shape")}
                        for r in kernels_w8])
    # K13's and K14's launches on the path counted by their T (rows a call)
    launches = run("main_path_w8a8", eng,
                   ("fused_scores", "flash_attend_int4", "flash_attend_int4_decode",
                    "flash_attend_int4_extra", "pool_decode_attend_int4", "rmsnorm_quant",
                    "silu_mul_quant"), quant=True)
    by_t = {n: {int(k.split(" T ")[1]): v for k, v in launches.items()
                if k.startswith(n + " T ")} for n in ("rmsnorm_quant", "silu_mul_quant")}
    log(phase="w8a8_launches_by_T",
        **{n: {str(t): c for t, c in sorted(v.items())} for n, v in by_t.items()})
    if any(sum(v.values()) != launches[n] for n, v in by_t.items()):
        raise AssertionError(f"K13/K14 calls by T {by_t} do not add up to their launches")
    if launches["flash_attend_int4"] == launches["flash_attend_int4_decode"]:
        raise AssertionError("K5's prefill form never launched on the W8A8-KV4 path")
    launches.update(counted("windowed_scoring", weng, ("windowed_attend",), windowed_pass,
                            eng, ctx_ids))
    for r in kernels_w8:
        r["launches"] = launches[r["name"]]
    kernels += kernels_w8 + kernels_f
    del eng, weng
    gc.collect()
    torch.cuda.empty_cache()

    # llama3.2-1b (head_dim 64): every attention on the masked route
    cfg = resolve_config(L1_MODEL)
    eng = Engine(L1_MODEL, config=cfg, dtype=torch.bfloat16, device="cuda",
                 max_new_tokens=NEW_TOKENS, seed=SEED)
    rng = np.random.default_rng(SEED)
    ctx_ids = rng.integers(0, cfg.vocab_size, CTX).astype(np.int32)
    queries = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32) for _ in range(3)]
    counted("llama1b_path", eng, (), llama1b_path, ctx_ids, queries, absent=tuple(LAUNCHES))
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    family_launches = family_paths(counted, tally, kernels, flat_kernels, no_fused)

    # the command line (kvzip_tpu_torch.cli) in-process, in a working
    # directory of its own; its launches join the kernels line
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    cli_eng = types.SimpleNamespace(name=CLI_MODEL, config=resolve_config(CLI_MODEL))
    quant_eng = types.SimpleNamespace(name=MODEL, config=resolve_config(MODEL))
    bf16_kernels = ("flash_attend", "fused_scores", "ragged_decode_attend", "pool_decode_attend")
    int4_kernels = ("flash_attend_int4", "flash_attend_int4_decode", "flash_attend_int4_extra",
                    "pool_decode_attend_int4", "w4a8_matmul_stacked_v2")
    cli_launches = {}
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        try:
            add_launches(cli_launches, counted("cli_test", cli_eng, bf16_kernels, cli_test, work,
                                               absent=int4_kernels))
            add_launches(cli_launches, counted("cli_eval", cli_eng, bf16_kernels[:3], cli_eval,
                                               work, absent=int4_kernels))
            add_launches(cli_launches, counted(
                "cli_demo", cli_eng, ("flash_attend", "fused_scores", "pool_decode_attend"),
                cli_demo, work, absent=int4_kernels))
            add_launches(cli_launches, counted(
                "cli_demo_quant", quant_eng, ("fused_scores", *int4_kernels[:1],
                                              *int4_kernels[2:]),
                cli_demo, work, CLI_QUANT, ("kvzip",), MODEL,
                absent=("flash_attend", "ragged_decode_attend", "pool_decode_attend")))
            # K5's decode form (counted within K5 too) on that phase, if any
            add_launches(cli_launches, {n: LAUNCHES[n] for n in int4_kernels[1:2]})
        finally:
            os.chdir(home)
    cli_launches["flash_attend_int4"] -= cli_launches["flash_attend_int4_decode"]
    cli_launches = {n: cli_launches.get(n, 0) for n in (*bf16_kernels, *int4_kernels)}
    log(phase="cli_launches", **cli_launches)
    for r in kernels:
        r["launches"] += cli_launches.get(r["name"], 0) + family_launches.get(r["name"], 0)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "rms_want",
            "worst_to_tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("exp_floor_ms", "composed_ms", "composed_per_shape", "padded_bound_ms", "t1_ms",
             "gemma3_rows")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: r[k] for k in extra if k in r}}
                                  for r in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
