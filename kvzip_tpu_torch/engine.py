"""KVzip engine of the port: prefill -> reconstruction scoring -> prune ->
decode over the pool (or the legacy flat layout, the compacted dense cache,
or a dense cache with a retain mask).

Port of the ``Engine``/``KVState`` of ``kvzip_tpu/engine.py`` (the evict
and retain paths, ``kv_type``; the prune's branches and the dense caches'
attention route, ``_use_flat`` and ``_impl``, as the reference's without
its backend tests; ``save_state``/``load_state`` in the port's own file
format, ``state_file.py``; bf16 or float32 weights and KV, random from a
seed, passed in (a v1 W4A8 tree with ``weight_quant="none"`` runs as it
is) or loaded from
a safetensors checkpoint directory given as ``model_name``, with the
quantized options ``kv_quant="int4"``, ``weight_quant="w8a8"`` or
``"w4a8"`` and ``embed_quant="int8"`` or ``"int4h"`` (int8 embedding, int4
lm_head), the fused W8A8 activation quantization
``act_fused="pallas"``, the windowed scoring ``scoring_attend="window"``,
the legacy flat decode layout ``flat_decode="legacy"``, the int8
attention ``attn_quant="int8"`` and the fused W4A8 decode layer,
``fuse_layer`` from ``KVZIP_MEGAKERNEL``).
PyTorch runs eagerly: the chunk loop and the layer loop are Python loops,
caches are updated in place, and the ``update_cache=False`` semantics are
O(1) counter restores as in the reference. The greedy decode loop is the
reference's on-device loop (``_decode_loop``): one decode step reads
nothing back (its counters, token buffer and end flag live on the
device; :class:`DecodeStep`), is captured once as a CUDA graph on the
card and replayed, and the host reads the tokens and the end flag once
every ``DECODE_CHUNK`` steps; on the CPU the same step runs eagerly in the
same loop.

Device rule: on a CUDA device every attention op of the kernels' route,
every W4A8 linear below 512 rows and every fused activation quantization
launches its kernel (K1-K16); on the CPU the same calls run the plain
PyTorch versions. The masked route (``attn_impl`` "dense"/"blockwise":
a pruned retain cache or a head_dim not a multiple of 128, as the
reference's XLA route) is torch ops on either device. Both devices
build the pool (or the flat layout) at prune time, and both honour
``attn_quant`` (the reference ignores it on the CPU, where its kernels run
in interpret mode).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kvzip_tpu_torch import ops
from kvzip_tpu_torch import prune as prune_lib
from kvzip_tpu_torch import state_file
from kvzip_tpu_torch import template as template_lib
from kvzip_tpu_torch.cache import (FlatInt4KV, FlatKV, Int4KVCache, KVCache,
                                   build_flat, build_flat_int4, build_flat_int4_stepped,
                                   compact, init_cache, init_int4_cache, refold_flat,
                                   restore, set_retain_mask, snapshot, synthetic_full_flat)
from kvzip_tpu_torch.config import ModelConfig, resolve_config
from kvzip_tpu_torch.models.params import prepare_params
from kvzip_tpu_torch.models.transformer import check_supported, forward
from kvzip_tpu_torch.pool import (PoolInt4KV, PoolKV, build_pool_int4_stepped,
                                  build_pool_stepped, refold_pool,
                                  synthetic_full_pool)
from kvzip_tpu_torch.tokenizer import load_tokenizer

# exact decomposition of any token count into a few chunk sizes
CHUNK_LADDER = (16384, 4096, 1024, 256, 64, 16, 4, 1)
POOL_LADDER = (64, 16, 4, 1)
# decode steps between two host reads of the answer and its end flag
DECODE_CHUNK = 8


def ladder_split(n: int, ladder: Sequence[int] = CHUNK_LADDER) -> List[int]:
    out: List[int] = []
    for size in ladder:
        while n >= size:
            out.append(size)
            n -= size
    return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _round_flat_rows(n: int) -> int:
    """Flat rows per layer (the reference's r_pad bucket): a multiple of
    8192 up to 65,536 rows, of 32,768 beyond."""
    return _round_up(n, 8192 if n <= 65536 else 32768)


DECODE_CACHES = (PoolKV, PoolInt4KV, FlatKV, FlatInt4KV)


@dataclasses.dataclass
class KVState:
    """One context's cache and its bookkeeping."""

    cache: Union[KVCache, Int4KVCache, PoolKV, PoolInt4KV, FlatKV, FlatInt4KV]
    kv_type: str
    sink: int                      # system-prompt rows, never evicted
    ctx_len: int
    prefill_len: int
    score: Optional[torch.Tensor] = None  # (L, Hkv, ctx_len)
    prefill_ids: Optional[np.ndarray] = None
    ctx_ids: Optional[np.ndarray] = None
    pruned: bool = False
    refolds: int = 0               # tail folds into the pool / flat rows so far
    _snap: Optional[dict] = None
    # the captured decode steps of this cache (a copy of the state starts
    # with none; a refold or a prune drops them with the cache they read)
    _steps: "_Steps" = dataclasses.field(default_factory=lambda: _Steps(), init=False,
                                          repr=False, compare=False)

    def snapshot(self):
        self._snap = snapshot(self.cache)

    def restore_snapshot(self):
        restore(self.cache, self._snap)

    def mem_gb(self) -> float:
        return round(self.cache.mem_bytes() / 1e9, 3)

    def used_gb(self) -> float:
        return round(self.cache.used_bytes() / 1e9, 3)


class _Steps(dict):
    """A state's decode steps by key; a copy of the state gets none."""

    def __copy__(self):
        return _Steps()

    def __deepcopy__(self, memo):
        return _Steps()


class CapturedStep:
    """A decode step (``self.step()``, no host read) over device buffers
    ``buf`` = [i, ...]: captured once as a CUDA graph on the card and
    replayed, run eagerly on the CPU. Launch counts: the capture's counts
    (``ops.counts_since``) are added once for each step that advanced
    (``ops.COUNTS``), as the eager calls would have counted them; a replay
    that advances nothing counts none."""

    def _capture(self, dev: torch.device, done: torch.Tensor) -> None:
        """A warm-up step that advances nothing (``done`` set) builds every
        kernel library and scratch buffer outside the capture; then the
        capture (``capture_s`` seconds, both)."""
        self.graph = None
        self.steps_read = 0  # i at the last host read
        saved = ops.counts_snapshot()
        done.fill_(1)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = ops.counts_snapshot()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.step()
            self.delta = ops.counts_since(warm)
            # the ticket buffers the graph replays, alive while it is
            self.tickets = ops.ticket_buffers()
            torch.cuda.synchronize(dev)
        else:
            self.step()
            self.delta = ops.counts_since(saved)
        self.capture_s = time.perf_counter() - t0
        ops.counts_restore(saved)

    def step(self) -> None:
        raise NotImplementedError

    def _run(self, n: int, head_len: int) -> list:
        """n steps (replays on the card), then one host read of ``buf``'s
        first ``head_len`` entries (``buf[0]`` the step index i)."""
        saved = None if self.graph is not None else ops.counts_snapshot()
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.step()
        head = self.buf[:head_len].tolist()
        if saved is not None:
            ops.counts_restore(saved)
        ops.counts_add(self.delta, head[0] - self.steps_read)
        self.steps_read = head[0]
        return head


class DecodeStep(CapturedStep):
    """One greedy decode step over a state's cache with no host read (the
    body of the reference's ``_decode_loop``): forward the token at step i
    (``collect_logits="last"``), write its argmax at i + 1 in a device
    token buffer, ``done |= (token in eos)``, i += 1; all of it, and the
    cache's counters, only while the answer is running (not done and i <
    the step budget); otherwise the step advances nothing and its rows land
    past the live tail, where nothing reads them (the engine has reserved
    the room). Captured and counted as :class:`CapturedStep` says.

    ``buf`` (int64): [i, done, token 0, token 1, ...]; the host reads its
    head once a chunk of steps.
    """

    def __init__(self, engine: "Engine", state: KVState, q8: bool, impl: str):
        cache = state.cache
        dev = engine.device
        self.engine, self.cache, self.q8, self.impl = engine, cache, q8, impl
        rows = (cache.k_tail.shape[2] if isinstance(cache, DECODE_CACHES)
                else cache.capacity)
        self.buf = torch.zeros(rows + 3, dtype=torch.int64, device=dev)
        self.i, self.done, self.tokens = self.buf[0:1], self.buf[1:2], self.buf[2:]
        self.budget = torch.zeros(1, dtype=torch.int64, device=dev)
        self.eos = torch.tensor(engine.eos_ids, dtype=torch.int64, device=dev)
        self._capture(dev, self.done)

    def step(self) -> None:
        eng = self.engine
        running = (self.done == 0) & (self.i < self.budget)
        ids = self.tokens.index_select(0, self.i)
        res = forward(eng.params, eng.config, ids, self.cache, collect_logits="last",
                      attn_q8=self.q8, fuse_layer=eng.fuse_layer, attn_impl=self.impl,
                      advance=running.to(torch.int32).reshape(()))
        nxt = torch.argmax(res.logits[-1]).reshape(1)
        at = self.i + 1
        self.tokens.index_copy_(0, at, torch.where(running, nxt, self.tokens.index_select(0, at)))
        self.done += running & (nxt[:, None] == self.eos).any(-1)
        self.i += running

    def start(self, last_logits: torch.Tensor, budget: int) -> None:
        """A new answer: token 0 the argmax of ``last_logits`` (the query's
        last row), done if it is an eos token, ``budget`` steps at most."""
        first = torch.argmax(last_logits).reshape(1)
        self.i.zero_()
        self.tokens[0:1].copy_(first)
        self.done.copy_((first[:, None] == self.eos).any(-1))
        self.budget.fill_(budget)
        self.steps_read = 0

    def run(self, n: int) -> Tuple[int, bool, list]:
        """n steps (replays on the card), then one host read: (i, done, the
        tokens 0..i)."""
        head = self._run(n, 3 + min(self.steps_read + n, self.tokens.numel() - 1))
        i = head[0]
        return i, bool(head[1]), head[2:3 + i]


class Engine:
    """KVzip engine (reference ``kvzip_tpu.engine.Engine``)."""

    def __init__(self, model_name: str, kv_type: str = "evict", *,
                 config: Optional[ModelConfig] = None, params=None,
                 tokenizer=None, dtype=torch.bfloat16, device="cuda",
                 max_new_tokens: int = 512, decode_budget: int = 768,
                 capacity_granularity: int = 512,
                 score_chunk_size: int = 2000, kv_quant: str = "none",
                 weight_quant: str = "none", embed_quant: str = "none",
                 act_fused: str = "xla", scoring_attend: str = "full",
                 flat_decode: str = "auto", attn_quant: str = "none",
                 attn_impl: str = "auto", seed: int = 0):
        """``kv_type``: "evict" (the prune evicts rows) or "retain" (the
        prune stores a mask and keeps every row, so one prefill can be
        pruned again at other ratios). ``act_fused``: "xla" (the W8A8 norm,
        activation and quantization as separate ops) or "pallas" (fused,
        K13 and K14; the values keep the reference's names).
        ``scoring_attend``: "full" (exact scoring) or "window" (the
        O(ctx * window) approximation through K9). ``flat_decode``: the
        evict path's decode layout (:meth:`_use_flat`), "auto" (the pool
        where head_dim is a multiple of 128) or "on" the pool, "legacy" the
        reference's round-3 flat layout (K10/K11), "off" the dense
        compaction (``cache.compact``). ``attn_quant``: "none" or "int8",
        the int8 attention (K7/K11 ``q8``) on an int4 pool or flat cache.
        ``attn_impl``: a dense cache's attention, "auto" (:meth:`_impl`),
        "flash" (the kernels), "dense" or "blockwise" (the masked route)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions")
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise TypeError("the CUDA kernels take bfloat16 weights and KV")
        if kv_type not in ("evict", "retain"):
            raise ValueError(f"kv_type: {kv_type!r}")
        if attn_impl not in ("auto", "flash", "dense", "blockwise"):
            raise ValueError(f"attn_impl: {attn_impl!r}")
        if kv_quant not in ("none", "int4"):
            raise ValueError(f"kv_quant: {kv_quant!r}")
        if act_fused not in ("xla", "pallas"):
            raise ValueError(f"act_fused: {act_fused!r}")
        if flat_decode not in ("auto", "on", "legacy", "off"):
            raise ValueError(f"flat_decode: {flat_decode!r}")
        if attn_quant not in ("none", "int8"):
            raise ValueError(f"attn_quant: {attn_quant!r}")
        self.flat_decode = flat_decode
        self.attn_quant = attn_quant
        self.attn_impl = attn_impl
        self.config = config or resolve_config(model_name)
        if act_fused == "pallas":
            self.config = dataclasses.replace(self.config, fused_act=True)
        if scoring_attend not in ("full", "window"):
            raise ValueError(f"scoring_attend: {scoring_attend!r}")
        if scoring_attend == "window" and self.config.is_hybrid:
            raise ValueError(
                "scoring_attend='window' is not supported for hybrid "
                "(gemma3) models — their scoring runs in forward_hybrid")
        self.scoring_attend = scoring_attend
        check_supported(self.config)
        self.name = (model_name.rstrip("/").split("/")[-1]
                     if "/" in model_name else model_name)
        self.kv_type = kv_type
        self.dtype = dtype
        self.max_new_tokens = max_new_tokens
        self.decode_budget = max(decode_budget, max_new_tokens + 128)
        self.capacity_granularity = capacity_granularity
        self.score_chunk_size = score_chunk_size
        self.score_width = _round_up(score_chunk_size, 128)
        self.score_q_pad = self.score_width + 256
        self.kv_quant = kv_quant
        gen = None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = prepare_params(
            self.config, params, dtype=dtype, weight_quant=weight_quant,
            embed_quant=embed_quant, generator=gen, device=self.device,
            model_name=model_name)
        self.tokenizer = tokenizer or load_tokenizer(
            model_name, vocab_size=self.config.vocab_size)
        eos = template_lib.eos_ids(model_name, self.tokenizer)
        if not eos:
            raise ValueError(
                f"no eos ids for {model_name!r}: the tokenizer declares "
                "none and the template table has no entry for this family")
        self.eos_ids = tuple(eos)
        self.set_chat_template()
        # the fused W4A8 decode layer (K12, ``ops/w4a8_fused.py``): "auto"
        # (on the card where the shapes allow), "on" (the CPU too, through
        # the plain version) or "off", from KVZIP_MEGAKERNEL as in the
        # reference, default off; tests set the attribute
        self.fuse_layer = os.environ.get("KVZIP_MEGAKERNEL", "off")

    # ------------------------------------------------------------------ text
    def encode(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        return np.asarray(ids, np.int32).reshape(-1)

    def decode(self, ids) -> str:
        return self.tokenizer.decode(np.asarray(ids).reshape(-1),
                                     skip_special_tokens=True)

    def set_chat_template(self, task: str = "qa"):
        prefix, postfix = template_lib.template(self.name, task)
        self.sys_prompt_ids = self.encode(prefix)
        self.postfix_ids = self.encode(postfix)

    def apply_template(self, query: str) -> np.ndarray:
        return np.concatenate([self.encode(f"\n\n{query.strip()}"),
                               self.postfix_ids])

    # --------------------------------------------------------------- forward
    def _q8(self, state: KVState) -> bool:
        """int8 attention applies to an int4 pool or flat cache only (the
        reference's ``_impl`` choice of "flash_q8")."""
        return self.attn_quant == "int8" and isinstance(state.cache, (PoolInt4KV, FlatInt4KV))

    def _use_flat(self, state: KVState) -> bool:
        """Does an evict prune build a decode layout (the pool, or the flat
        layout with ``flat_decode="legacy"``)? The reference's rule without
        its backend test: the port builds both layouts on either device.
        Otherwise the prune compacts the dense cache (``cache.compact``), or
        at head level updates its lengths."""
        if self.flat_decode == "off":
            return False
        if self.kv_quant == "int4" and self.config.head_dim != 128:
            return False
        if self.flat_decode in ("on", "legacy"):
            return True
        return self.config.head_dim % 128 == 0

    def _impl(self, state: KVState) -> str:
        """The attention of the state's cache (the reference's ``_impl``):
        a pool or flat cache runs its kernels; a dense cache "flash" (the
        kernels) unless it is a pruned retain cache (the kernels read no
        mask) or head_dim is not a multiple of 128, else the masked route:
        "dense" up to 4,096 rows a head, "blockwise" above. The reference
        also sends a capacity that is not a multiple of 128 to the masked
        route (a Mosaic block limit); the port's kernels take any
        capacity, so it does not. ``attn_impl`` other than "auto" is taken
        as given, but "flash" on a pruned retain cache raises."""
        if isinstance(state.cache, DECODE_CACHES):
            return "flash"
        needs_valid = state.pruned and state.kv_type == "retain"
        if self.attn_impl != "auto":
            if self.attn_impl == "flash" and needs_valid:
                raise ValueError("attn_impl='flash' reads no retain mask: a pruned retain "
                                 "cache needs 'dense' or 'blockwise'")
            return self.attn_impl
        if not needs_valid and self.config.head_dim % 128 == 0:
            return "flash"
        return "dense" if state.cache.capacity <= 4096 else "blockwise"

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _forward_chunks(self, ids: np.ndarray, state: KVState,
                        collect: str = "none") -> Optional[torch.Tensor]:
        """Run ids through the model on the chunk ladder; maybe return
        logits ("last" or "all"). The caller has checked the cache's room
        (``_check_capacity``)."""
        ladder = POOL_LADDER if isinstance(state.cache, DECODE_CACHES) else CHUNK_LADDER
        q8 = self._q8(state)
        impl = self._impl(state)
        parts = []
        pos = 0
        for size in ladder_split(len(ids), ladder):
            chunk = ids[pos:pos + size]
            pos += size
            want = collect if collect == "all" else (
                "last" if pos == len(ids) and collect == "last" else "none")
            res = forward(self.params, self.config, self._ids(chunk),
                          state.cache, collect_logits=want, sink=state.sink, attn_q8=q8,
                          fuse_layer=self.fuse_layer, attn_impl=impl)
            if res.logits is not None:
                parts.append(res.logits)
        if collect == "all":
            return torch.cat(parts, dim=0)
        return parts[-1] if collect == "last" else None

    # --------------------------------------------------------------- prefill
    def prefill(self, ctx: Union[str, np.ndarray],
                prefill_chunk_size: int = 16000, load_score: bool = False,
                do_score: bool = True,
                head_score_dirs: Sequence[str] = ("./head_score",)) -> KVState:
        """Chunked prefill and (optionally) KV importance scoring."""
        ctx_ids = self.encode(ctx) if isinstance(ctx, str) else np.asarray(ctx)
        prefill_ids = np.concatenate([self.sys_prompt_ids, ctx_ids])
        sink = int(len(self.sys_prompt_ids))
        prefill_len = int(len(prefill_ids))
        extra = max(self.score_q_pad, self.decode_budget)
        capacity = _round_up(prefill_len + extra, self.capacity_granularity)
        init = init_int4_cache if self.kv_quant == "int4" else init_cache
        state = KVState(
            cache=init(self.config, capacity, self.dtype, self.device),
            kv_type=self.kv_type, sink=sink, ctx_len=int(len(ctx_ids)),
            prefill_len=prefill_len, prefill_ids=prefill_ids, ctx_ids=ctx_ids)
        pos = 0
        while pos < prefill_len:
            n = min(prefill_chunk_size, prefill_len - pos)
            if n < prefill_chunk_size and n % 256:
                # pad the final partial chunk to a multiple of 256 (the
                # reference's shape discipline); rolling the counters back
                # makes the pad rows dead, and causal masking keeps them out
                # of every real token's attention during the chunk
                p = _round_up(n, 256)
                buf = np.zeros((p,), np.int32)
                buf[:n] = prefill_ids[pos:pos + n]
                self._forward_chunks(buf, state)
                state.cache.lengths -= p - n
                state.cache.seen -= p - n
            else:
                self._forward_chunks(prefill_ids[pos:pos + n], state)
            pos += n
        state.snapshot()
        if do_score:
            self.scoring(state, ctx_ids, load_score=load_score,
                         head_score_dirs=head_score_dirs)
        return state

    # --------------------------------------------------------------- scoring
    def self_task(self, ctx_ids: np.ndarray, chunk_size: int = 2000,
                  prev_postfix_size: int = 8
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(chunk, repeat-prompt | prev-tail | postfix | chunk) pairs."""
        chunks = [ctx_ids[i:i + chunk_size]
                  for i in range(0, len(ctx_ids), chunk_size)]
        out = []
        for i, a_ids in enumerate(chunks):
            if i == 0:
                q_ids = self.encode("\n\nRepeat the previous context exactly.")
            else:
                q_ids = self.encode(
                    "\n\nRepeat the part of the previous context exactly, "
                    "starting with ")
                q_ids = np.concatenate([q_ids, chunks[i - 1][-prev_postfix_size:]])
            out.append((a_ids, np.concatenate([q_ids, self.postfix_ids, a_ids])))
        return out

    def scoring(self, state: KVState, ctx_ids: np.ndarray,
                load_score: bool = False,
                head_score_dirs: Sequence[str] = ("./head_score",)):
        """KV importance scoring by context reconstruction; the scores land
        in ``state.score`` as (L, Hkv, ctx_len)."""
        cfg = self.config
        if load_score:
            state.score = prune_lib.load_head_score(
                self.name, state.ctx_len, head_score_dirs).to(self.device)
            return
        # one window of slack: chunks advance by score_chunk_size but each
        # write is score_width wide
        score = torch.zeros(
            (cfg.num_layers, cfg.num_kv_heads,
             _round_up(max(state.ctx_len, 1), self.score_width) + self.score_width),
            dtype=torch.float32, device=self.device)
        start = state.sink
        impl = self._impl(state)
        for a_ids, rep_ids in self.self_task(ctx_ids, self.score_chunk_size):
            n_q = len(rep_ids)
            if n_q > self.score_q_pad:
                raise ValueError(
                    f"repeat pass needs {n_q} tokens > score_q_pad "
                    f"{self.score_q_pad}; raise score_chunk_size padding")
            rep_padded = np.zeros((self.score_q_pad,), np.int32)
            rep_padded[:n_q] = rep_ids
            res = forward(self.params, cfg, self._ids(rep_padded), state.cache,
                          scoring=True, score_start=start, score_len=len(a_ids),
                          score_qlen=n_q, score_width=self.score_width,
                          sink=state.sink, scoring_attend=self.scoring_attend,
                          attn_impl=impl)
            o = start - state.sink
            score[:, :, o:o + len(a_ids)] = res.chunk_scores[:, :, :len(a_ids)].float()
            start += len(a_ids)
            state.restore_snapshot()
        if start - state.sink != state.ctx_len:
            raise RuntimeError("scoring windows do not cover the context")
        state.score = score[:, :, :state.ctx_len]

    # ----------------------------------------------------------------- prune
    def prune(self, state: KVState, ratio: float, level: str = "pair"
              ) -> Tuple[float, float]:
        """Prune the cache at ``ratio``; returns (threshold, true_ratio).
        The reference's four branches, in order: a retain state stores the
        mask and keeps its scores (it can be pruned again at another
        ratio); an evict prune at head level where no decode layout applies
        (:meth:`_use_flat`) sets the dropped heads' lengths to the sink, no
        row moving; else the pool (the flat layout with
        ``flat_decode="legacy"``); else the dense compaction into
        ``round_up(kept + decode_budget, capacity_granularity)`` rows a
        head. An evict prune is one-shot. Every prune drops the state's
        captured decode steps."""
        if isinstance(state.cache, DECODE_CACHES) or (state.kv_type == "evict"
                                                      and state.pruned):
            raise RuntimeError(
                "evict-path prune is one-shot (the cache was physically "
                "compacted); use kv_type='retain' to sweep multiple ratios")
        if state.score is None:
            raise RuntimeError("run scoring() first")
        keep, thres, true_ratio = prune_lib.prune_mask(
            state.score, ratio, level, method="histogram")
        state._steps.clear()
        if state.kv_type == "retain":
            set_retain_mask(state.cache, keep, state.sink)
        elif level == "head" and not self._use_flat(state):
            # whole heads kept or dropped: eviction is a lengths update,
            # attention reads [0, lengths) of each head
            state.score = None
            lens = state.cache.lengths
            lens.copy_(torch.where(keep.any(dim=-1), lens, torch.full_like(lens, state.sink)))
        else:
            state.score = None
            dense = state.cache
            if not self._use_flat(state):
                kept = int(keep.sum(dim=-1).max()) + state.sink
                state.cache = compact(dense, keep, state.sink, _round_up(
                    kept + self.decode_budget, self.capacity_granularity))
            elif self.flat_decode == "legacy":
                # the reference's round-3 layout: every layer padded to the
                # largest one's kept rows (sink included)
                per_layer = keep.sum(dim=(1, 2))
                r_pad = _round_flat_rows(int(per_layer.max())
                                         + state.sink * self.config.num_kv_heads)
                if isinstance(dense, Int4KVCache):
                    state.cache = build_flat_int4_stepped(dense, keep, state.sink, r_pad,
                                                          self.decode_budget, self.dtype)
                else:
                    state.cache = build_flat(dense, keep, state.sink, r_pad,
                                             self.decode_budget)
            elif isinstance(dense, Int4KVCache):
                state.cache = build_pool_int4_stepped(dense, keep, state.sink,
                                                      self.decode_budget, self.dtype)
            else:
                state.cache = build_pool_stepped(dense, keep, state.sink,
                                                 self.decode_budget)
            del dense
        state.pruned = True
        state.snapshot()
        return thres, true_ratio

    def flatten_full(self, state: KVState) -> KVState:
        """The flat layout of the FULL dense cache (every context row kept):
        the full-cache decode baseline through the same kernel (K10 or K11)
        as the evicted flat cache. Returns a new state; the input state and
        its dense cache are left intact."""
        if isinstance(state.cache, DECODE_CACHES):
            raise RuntimeError("cache is already a decode layout")
        L, H = self.config.num_layers, self.config.num_kv_heads
        keep = torch.ones((L, H, state.ctx_len), dtype=torch.bool, device=self.device)
        r_pad = _round_flat_rows(H * (state.ctx_len + state.sink))
        if isinstance(state.cache, Int4KVCache):
            cache = build_flat_int4(state.cache, keep, state.sink, r_pad,
                                    self.decode_budget, self.dtype)
        else:
            cache = build_flat(state.cache, keep, state.sink, r_pad, self.decode_budget)
        new_state = dataclasses.replace(state, cache=cache, pruned=True)
        new_state.snapshot()
        return new_state

    def synthetic_full_flat_state(self, state: KVState, flat_int4: bool,
                                  tail_cap: int) -> KVState:
        """A full-occupancy flat cache (int4 with ``flat_int4``) with the
        live rows ``flatten_full(state)`` would give, every layer padded to
        their r_pad bucket: the full-cache decode baseline once the dense
        cache is gone."""
        cfg = self.config
        per_head = state.ctx_len + state.sink
        cache = synthetic_full_flat(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, per_head,
            _round_flat_rows(cfg.num_kv_heads * per_head), tail_cap, self.dtype,
            self.device, int4=flat_int4)
        st = dataclasses.replace(state, cache=cache, pruned=True)
        st.snapshot()
        return st

    def synthetic_full_pool_state(self, state: KVState, int4: bool,
                                  tail_cap: int) -> KVState:
        """A full-occupancy pool (int4 with ``int4``) with the geometry of an
        all-rows-kept build: the full-cache decode baseline, which runs
        through the same kernel (K3 or K7) as the evicted cache. The
        arguments are in the reference's order (``bench.py`` passes them
        positionally)."""
        cfg = self.config
        cache = synthetic_full_pool(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
            state.ctx_len + state.sink, tail_cap, self.dtype, self.device,
            int4=int4)
        st = dataclasses.replace(state, cache=cache, pruned=True)
        st.snapshot()
        return st

    # ------------------------------------------------------ state save/load
    def save_state(self, state: KVState, path: str) -> str:
        """Save a pruned pool state (``state_file``'s format: the pool's
        arrays and device counters in an npz, bfloat16 as uint16 bits,
        beside a JSON sidecar), so a later run serves the compressed cache
        without prefill and scoring again (reference ``save_state``).
        Returns the npz path."""
        cache = state.cache
        if not isinstance(cache, (PoolKV, PoolInt4KV)):
            raise ValueError("save_state saves a pool cache (after an evict prune)")
        arrays, dtypes = {}, {}
        for name in [f.name for f in dataclasses.fields(cache)] + ["tail_lens"]:
            v = getattr(cache, name)
            if name == "tail_len" or not isinstance(v, torch.Tensor):
                continue
            dtypes[name] = str(v.dtype).replace("torch.", "")
            v = v.detach().cpu()
            arrays[name] = (v.view(torch.int16).numpy().view(np.uint16)
                            if v.dtype == torch.bfloat16 else v.numpy())
        return state_file.write(path, arrays, dtypes, dict(
            kind=type(cache).__name__, align=cache.align, max_rows=cache.max_rows,
            model=self.name, kv_type=state.kv_type, sink=state.sink, ctx_len=state.ctx_len,
            prefill_len=state.prefill_len, dtype=str(self.dtype).replace("torch.", "")))

    def load_state(self, path: str) -> KVState:
        """A :meth:`save_state` file (or a converted ``kvzip_tpu`` one,
        ``state_file.convert_reference_state``) as a pruned pool state on
        the engine's device; the (empty) tail grown to this engine's
        ``decode_budget`` where the file's is shorter."""
        arrays, meta = state_file.read(path)
        if meta["model"] != self.name:
            raise ValueError(f"state was saved for {meta['model']!r}, engine is {self.name!r}")
        if meta["dtype"] != str(self.dtype).replace("torch.", ""):
            raise ValueError(f"state holds {meta['dtype']} KV, the engine {self.dtype}")

        def tensor(name, a):
            if meta["array_dtypes"][name] == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(self.device)
            return torch.from_numpy(a).to(self.device)

        t = {k: tensor(k, v) for k, v in arrays.items()}
        grow = self.decode_budget - t["k_tail"].shape[2]
        if grow > 0:
            for f in ("k_tail", "v_tail"):
                t[f] = torch.nn.functional.pad(t[f], (0, 0, 0, grow))
        tail_lens, seen = t.pop("tail_lens"), t.pop("seen")
        cls = PoolInt4KV if meta["kind"] == "PoolInt4KV" else PoolKV
        cache = cls(**t, tail_len=tail_lens[0], seen=seen, align=int(meta["align"]),
                    max_rows=int(meta["max_rows"]))
        cache.tail_lens.copy_(tail_lens)
        state = KVState(cache=cache, kv_type=meta["kv_type"], sink=int(meta["sink"]),
                        ctx_len=int(meta["ctx_len"]), prefill_len=int(meta["prefill_len"]),
                        pruned=True)
        state.snapshot()
        return state

    # -------------------------------------------------------------- generate
    def _check_capacity(self, state: KVState, need: int, cur: Optional[int] = None):
        """Fail loudly instead of writing past the cache: the one room check
        of a call that forwards into it (``forward`` reads nothing back).
        ``cur``: a pool or flat cache's tail length already read (a generate
        reads it once and shares it with ``_maybe_refold``, as the
        reference does)."""
        cache = state.cache
        if isinstance(cache, DECODE_CACHES):
            cap = cache.k_tail.shape[2]
            cur = int(cache.tail_len) if cur is None else cur
            if cur + need > cap:
                raise ValueError(
                    f"query+generation needs {need} tail rows but only "
                    f"{cap - cur} remain (decode_budget={cap}); raise "
                    f"decode_budget or lower max_new_tokens")
        else:
            cur = int(cache.lengths.max())
            if cur + need > cache.capacity:
                raise ValueError(
                    f"query+generation needs {need} rows beyond {cur} but "
                    f"capacity is {cache.capacity}; raise decode_budget")

    def _maybe_refold(self, state: KVState, need: int, cur: int) -> bool:
        """Fold the committed tail (``cur`` rows) into the pool or the flat
        rows when the next turn would overflow it; returns whether it
        did."""
        cache = state.cache
        if not isinstance(cache, DECODE_CACHES):
            return False
        if cur + need <= cache.k_tail.shape[2]:
            return False
        state._steps.clear()
        if isinstance(cache, (FlatKV, FlatInt4KV)):
            rows = int((cache.lengths + cur).sum(dim=-1).max())
            state.cache = refold_flat(cache, _round_flat_rows(rows))
        else:
            state.cache = refold_pool(cache)
        state.refolds += 1
        state.snapshot()
        return True

    def generate(self, query: Union[str, np.ndarray], state: KVState,
                 update_cache: bool = False,
                 max_new_tokens: Optional[int] = None) -> str:
        """Greedy generation against the (compressed) cache. By default the
        context cache is restored afterwards; ``update_cache=True`` keeps
        the query and answer KV for multi-turn."""
        return self.decode(self.generate_ids(query, state, update_cache,
                                             max_new_tokens))

    def generate_ids(self, query: Union[str, np.ndarray], state: KVState,
                     update_cache: bool = False,
                     max_new_tokens: Optional[int] = None) -> np.ndarray:
        """:meth:`generate`, returning the answer's token ids (eos
        excluded)."""
        return self._generate(query, state, update_cache, max_new_tokens, self._decode_loop)

    def _generate(self, query, state: KVState, update_cache: bool,
                  max_new_tokens: Optional[int], loop) -> np.ndarray:
        """The query's forward, then ``loop(state, last_logits, max_new)``
        (the answer's tokens, eos excluded), then the restore or the
        commit. The tail length is read once (the reference's one
        ``device_get``)."""
        query_ids = (self.encode(query) if isinstance(query, str)
                     else np.asarray(query))
        max_new = max_new_tokens or self.max_new_tokens
        need = len(query_ids) + max_new
        # the tail only holds committed rows between generates, so folding
        # is always sound, whatever update_cache is
        cur = (int(state.cache.tail_len) if isinstance(state.cache, DECODE_CACHES)
               else None)
        if self._maybe_refold(state, need, cur):
            cur = 0
        self._check_capacity(state, need, cur)
        state.snapshot()

        logits = self._forward_chunks(query_ids.astype(np.int32), state, "last")
        tokens = loop(state, logits[-1], max_new)

        if not update_cache:
            state.restore_snapshot()
        else:
            state.prefill_ids = np.concatenate(
                [state.prefill_ids, query_ids, tokens]).astype(np.int32)
            state.snapshot()
        return np.asarray(tokens, np.int32)

    def decode_step(self, state: KVState) -> DecodeStep:
        """The state's decode step for this engine, its eos ids,
        ``fuse_layer`` and int8-attention mode, captured at its first use
        and kept on the state with its cache (a refold or a prune drops the
        steps; so does a cache the caller put in the state)."""
        q8, impl = self._q8(state), self._impl(state)
        key = (self, tuple(self.eos_ids), self.fuse_layer, q8, impl)
        steps = state._steps
        if any(st.cache is not state.cache for st in steps.values()):
            steps.clear()
        if key not in steps:
            steps[key] = DecodeStep(self, state, q8, impl)
        return steps[key]

    def _decode_loop(self, state: KVState, last_logits: torch.Tensor,
                     max_new: int) -> list:
        """The reference's on-device loop: token 0 from the query's last
        logits, then at most ``max_new - 1`` steps of the captured decode
        step (the eos token and the last token are never forwarded), the
        host reading the answer once every ``DECODE_CHUNK`` steps."""
        step = self.decode_step(state)
        budget = max_new - 1
        step.start(last_logits, budget)
        while True:
            i, done, tokens = step.run(min(DECODE_CHUNK, budget - step.steps_read))
            if done or i >= budget:
                break
        return tokens[:-1] if done else tokens

    def _per_token_loop(self, state: KVState, last_logits: torch.Tensor,
                        max_new: int) -> list:
        """The port's first decode loop: one eager forward and one host read
        of its argmax a token (see :func:`generate_ids_per_token`)."""
        tokens = [int(torch.argmax(last_logits))]
        done = tokens[-1] in self.eos_ids
        q8, impl = self._q8(state), self._impl(state)
        while not done and len(tokens) < max_new:
            res = forward(self.params, self.config, self._ids(tokens[-1:]),
                          state.cache, collect_logits="last", sink=state.sink, attn_q8=q8,
                          fuse_layer=self.fuse_layer, attn_impl=impl)
            tokens.append(int(torch.argmax(res.logits[-1])))
            done = tokens[-1] in self.eos_ids
        return tokens[:-1] if done else tokens

    # --------------------------------------------------------------- __call__
    def forward_ids(self, input_ids: np.ndarray, state: KVState,
                    update_cache: bool = False,
                    return_logits: bool = False) -> Optional[np.ndarray]:
        """Plain forward; the cache is restored afterwards unless
        ``update_cache``."""
        self._check_capacity(state, len(input_ids))
        if not update_cache:
            state.snapshot()
        logits = self._forward_chunks(np.asarray(input_ids, np.int32), state,
                                      "all" if return_logits else "none")
        if not update_cache:
            state.restore_snapshot()
        return logits.float().cpu().numpy() if return_logits else None

    def prob(self, input_ids: np.ndarray, state: KVState) -> np.ndarray:
        """Next-token probabilities for every position; restores the cache."""
        self._check_capacity(state, len(input_ids))
        state.snapshot()
        logits = self._forward_chunks(np.asarray(input_ids, np.int32), state, "all")
        state.restore_snapshot()
        return torch.softmax(logits.float(), dim=-1).cpu().numpy()


def generate_ids_per_token(engine: Engine, query: Union[str, np.ndarray], state: KVState,
                           update_cache: bool = False,
                           max_new_tokens: Optional[int] = None) -> np.ndarray:
    """:meth:`Engine.generate_ids` through the port's first decode loop: an
    eager forward from Python and a host read of its argmax every token. A
    yardstick for the captured step (``chip_smoke.py`` times both, tests
    hold their tokens equal), not a route of the engine."""
    return engine._generate(query, state, update_cache, max_new_tokens,
                            engine._per_token_loop)
