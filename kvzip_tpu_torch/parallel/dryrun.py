"""Multi-rank dry run of the port's parallel paths, and its rank launcher.

    python -m kvzip_tpu_torch.parallel.dryrun N     # N gloo ranks on the CPU
    torchrun --nproc-per-node N -m kvzip_tpu_torch.parallel.dryrun N   # cards

Port of the legs of ``__graft_entry__.py::dryrun_multichip`` that run on a
mesh, on a tiny llama (8 heads over 4 kv heads), float32 on the CPU, bf16
on the cards:

1. TP+DP evict pipeline: prefill, scoring, prune, decode over the mesh
   (tp the largest of 4, 2, 1 dividing N; "data" the rest);
2. ring-attention prefill through ``Engine(seq_parallel=True)`` (a "data"
   axis of N / max(1, tp // 2)), the same answer as leg 1;
3b. pool-TP: per-rank pools at tp 2, the same answer as leg 1;
4. continuous batching (``Scheduler.run_continuous``, 2 slots, 3
   requests, one admitted mid-flight) on leg 1's mesh.

Started without a process group it spawns N gloo ranks of its own
(:func:`spawn`); under torchrun it joins the group torchrun describes
(NCCL on the cards). Rank 0 prints each leg.
"""

from __future__ import annotations

import os
import sys
import tempfile
import traceback


def _rank_main(rank: int, world: int, store_path: str, out_dir: str, fn, args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        err = None
    except Exception:  # reported to the launcher with its traceback
        result, err = None, traceback.format_exc()
    torch.save({"result": result, "error": err}, os.path.join(out_dir, f"rank{rank}.pt"))
    if err is None:
        dist.barrier()
    dist.destroy_process_group()
    if err is not None:
        sys.stderr.write(err)
        sys.exit(1)


def spawn(world: int, fn, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in a gloo group (a FileStore in a temporary directory, no TCP port; one
    torch thread each); returns each rank's result, rank order. A rank's
    failure raises here with its traceback; ranks still running after
    ``timeout`` seconds are killed and raise ``TimeoutError``. ``fn`` must
    be importable by name (a module's top-level function)."""
    import time

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(_rank_main, args=(world, store, tmp, fn, args),
                                 nprocs=world, start_method="spawn", join=False)
        failed, deadline = None, time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"{world} ranks still running after {timeout} s")
        except mp.ProcessRaisedException as e:
            failed = e
        except mp.ProcessExitedException as e:  # a rank exited non-zero
            failed = e
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pt")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result")
                continue
            got = torch.load(path, weights_only=False)
            if got["error"]:
                errors.append(f"rank {r}:\n{got['error']}")
            results.append(got["result"])
        if errors or failed is not None:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors) + f"\n{failed or ''}")
        return results


def _say(*a) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(*a, flush=True)


def legs(rank: int, world: int, device: str = "cpu", repeat: int = 40) -> dict:
    """The four legs on this rank; returns the answers by leg. ``repeat``:
    the context's sentence count (the reference's 40; fewer for a quick
    run)."""
    import torch

    from kvzip_tpu_torch.config import tiny_config
    from kvzip_tpu_torch.engine import Engine
    from kvzip_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from kvzip_tpu_torch.serving import Scheduler
    from kvzip_tpu_torch.tokenizer import ByteTokenizer

    tp = next(c for c in (4, 2, 1) if world % c == 0)
    cfg = tiny_config("llama")
    dtype = torch.float32 if device == "cpu" else torch.bfloat16
    tok = ByteTokenizer(cfg.vocab_size)
    base = Engine("tiny-llama", config=cfg, dtype=dtype, device=device, tokenizer=tok)

    def engine(mesh, **kw):
        return Engine("tiny-llama", kv_type="evict", config=cfg, dtype=dtype, device=device,
                      max_new_tokens=4, decode_budget=256, capacity_granularity=256,
                      score_chunk_size=256, params=base.params, tokenizer=tok, mesh=mesh,
                      **kw)

    ctx = "dry run context for the multi-chip sharding check. " * repeat
    q = "What is this?"
    out = {}

    mesh = make_mesh(tp=tp)
    eng = engine(mesh)
    st = eng.prefill(ctx, prefill_chunk_size=256)
    eng.prune(st, 0.5, "pair")
    out["leg1"] = eng.generate(eng.apply_template(q), st, max_new_tokens=4)
    _say(f"leg1 tp-pipeline ok: mesh={mesh_shape(mesh)} out={out['leg1']!r}")

    if world >= 2:
        mesh_sp = make_mesh(tp=max(1, tp // 2))
        eng_sp = engine(mesh_sp, seq_parallel=True)
        st_sp = eng_sp.prefill(ctx, prefill_chunk_size=256)
        eng_sp.prune(st_sp, 0.5, "pair")
        out["leg2"] = eng_sp.generate(eng_sp.apply_template(q), st_sp, max_new_tokens=4)
        if out["leg2"] != out["leg1"]:
            raise AssertionError(f"ring prefill answered {out['leg2']!r}, leg 1 {out['leg1']!r}")
        _say(f"leg2 ring-prefill ok: mesh={mesh_shape(mesh_sp)} out={out['leg2']!r}")

        mesh_p = make_mesh(tp=2)
        eng_p = engine(mesh_p, flat_decode="on")
        st_p = eng_p.prefill(ctx, prefill_chunk_size=256)
        eng_p.prune(st_p, 0.5, "pair")
        if getattr(st_p.cache, "tp", 0) != 2:
            raise AssertionError(f"no TP pool: {type(st_p.cache).__name__}")
        out["leg3b"] = eng_p.generate(eng_p.apply_template(q), st_p, max_new_tokens=4)
        if out["leg3b"] != out["leg1"]:
            raise AssertionError(f"pool-TP answered {out['leg3b']!r}, leg 1 {out['leg1']!r}")
        _say(f"leg3b pool-TP ok: mesh={mesh_shape(mesh_p)} shards={st_p.cache.tp} "
             f"out={out['leg3b']!r}")

    eng_s = engine(mesh, flat_decode="off")
    states = [eng_s.prefill(c, prefill_chunk_size=256) for c in
              (ctx, "another context about teal pigments. " * (repeat * 3 // 4),
               "a third context mentioning granite. " * (repeat * 3 // 4))]
    for s in states:
        eng_s.prune(s, 0.5, "pair")
    sched = Scheduler(eng_s, max_batch=2)
    for s in states:
        sched.submit(eng_s.apply_template(q), s, max_new_tokens=4)
    out["leg4"] = sched.run_continuous(segment=2)
    if len(out["leg4"]) != 3 or not all(isinstance(o, str) for o in out["leg4"]):
        raise AssertionError(f"continuous batching gave {out['leg4']!r}")
    _say(f"leg4 continuous-batching ok: {len(out['leg4'])} outputs")
    _say(f"dryrun ok: world={world} mesh={mesh_shape(mesh)} out={out['leg1']!r}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    if "WORLD_SIZE" in os.environ:  # started by torchrun: NCCL over the cards
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
        if dist.get_world_size() != n:
            raise SystemExit(f"asked for {n} ranks, torchrun started {dist.get_world_size()}")
        legs(dist.get_rank(), n, "cuda")
        dist.destroy_process_group()
        return 0
    spawn(n, legs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
