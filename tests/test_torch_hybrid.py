"""Gemma3's hybrid cache and forward in the port (``cache.HybridKV``,
``models/hybrid.py::forward_hybrid``) against the JAX package, in float32
on the CPU; the port's counterpart of ``tests/test_gemma3_hybrid.py``.

The engines share the reference's weights with every norm weight drawn
from a numpy seed (``test_torch_families.seeded_tree``) and take token ids
(a context of 768 - sink ids in chunks of 256, so the reference compiles
few shapes). Holds:

- an evict request is retain; the kernels' ``attn_impl`` is refused;
- prefill and scoring: scores within 1e-5, the sliding layers' rows zero;
  the static-only keep mask equal to the reference's away from the
  threshold, and ``valid`` (static layers only) equal after the prune;
  the prune's ratio counts the static layers only; the answers equal the
  reference's;
- the rings hold ``W = max(128, ceil(window / 128) * 128)`` rows whatever
  the capacity;
- after the ring has wrapped four times, the hybrid's logits equal the
  reference's ``forward_hybrid`` (atol 1e-4) and the port's plain forward
  over a dense cache with the window mask (atol 1e-4), at pattern 2 and at
  pattern 6 on a 7-layer config (one static layer, five 128 + 37 tokens);
- two generates of one query on one state give the same tokens after the
  ring has wrapped, and the rings and counters are back at the snapshot;
  the captured step's ``advance`` leaves the ring as the per-token loop
  does when the answer ends inside a chunk of steps;
- a v1 W4A8 tree through ``forward_hybrid`` (K16's plain version, seven
  calls a layer) against the reference's ``_w4a8_jnp`` route: logits within
  2e-2 of their largest magnitude. The two frameworks' activation scales
  differ in a last bit, which rounds one int8 activation of a row the
  other way (measured: row 15 of a 160-token chunk first differs, 6.8e-3
  of the largest logit from there on; the one-token step after it 3e-7);
  leaving out the post-norms or the qk-norm, or unit q_norm weights, gives
  more than 1.1;
- a fused W4A8 tree raises, naming the v1 route; save_state and the
  serving batch refuse a hybrid state.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import prune as jprune
from kvzip_tpu.cache import init_hybrid_cache as j_init_hybrid_cache
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.models.hybrid import forward_hybrid as j_forward_hybrid
from kvzip_tpu.ops import w4a8 as jw4a8
from kvzip_tpu_torch import prune
from kvzip_tpu_torch import serving
from kvzip_tpu_torch.cache import HybridKV, init_cache, init_hybrid_cache, snapshot
from kvzip_tpu_torch.engine import Engine, generate_ids_per_token
from kvzip_tpu_torch.models import transformer
from kvzip_tpu_torch.models.hybrid import forward_hybrid
from kvzip_tpu_torch.models.params import params_from_jax

from test_torch_engine import IdTokenizer, one_torch_thread  # noqa: F401
from test_torch_families import seeded_tree
from test_torch_model import _port_cfg

KW = dict(max_new_tokens=6, decode_budget=256, capacity_granularity=256,
          score_chunk_size=256)


def _engines(cfg, tree, **kw):
    kw = dict(KW, tokenizer=IdTokenizer(cfg.vocab_size), **kw)
    jeng = JEngine("tiny-gemma3", kv_type="evict", config=cfg,
                   params=jax.tree_util.tree_map(jnp.asarray, tree), dtype=jnp.float32, **kw)
    teng = Engine("tiny-gemma3", kv_type="evict", config=_port_cfg(cfg),
                  params=params_from_jax(tree, "cpu", torch.float32), dtype=torch.float32,
                  device="cpu", **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_config("gemma3")
    return _engines(cfg, seeded_tree(cfg, scale=7.0))


def _ctx(eng, seed=1, total=768):
    rng = np.random.default_rng(seed)
    return rng.integers(1, eng.config.vocab_size - 1,
                        total - len(eng.sys_prompt_ids)).astype(np.int32)


def _query(seed=2):
    return np.random.default_rng(seed).integers(1, 500, 16).astype(np.int32)


@pytest.fixture(scope="module")
def scored(engines):
    jeng, teng = engines
    ctx = _ctx(teng)
    return (jeng.prefill(ctx, prefill_chunk_size=256),
            teng.prefill(ctx, prefill_chunk_size=256))


def test_hybrid_forced_retain(engines):
    _, teng = engines
    assert teng.kv_type == "retain"
    with pytest.raises(ValueError, match="masked route"):
        Engine("tiny-gemma3", config=teng.config, params=teng.params,
               tokenizer=teng.tokenizer, dtype=torch.float32, device="cpu", attn_impl="flash")


def test_hybrid_scores_and_keep_mask_match_reference(engines, scored):
    jeng, teng = engines
    jst, tst = copy.deepcopy(scored)
    cfg = teng.config
    static = cfg.static_layer_ids
    assert isinstance(tst.cache, HybridKV) and 0 < len(static) < cfg.num_layers
    j_score, t_score = np.asarray(jst.score), tst.score.numpy()
    np.testing.assert_allclose(t_score, j_score, rtol=1e-5, atol=1e-5)
    for l in range(cfg.num_layers):
        if l not in static:
            assert not t_score[l].any(), f"sliding layer {l} scored"
    j_keep, thres, _ = jprune.prune_mask(jnp.asarray(j_score), 0.5, "pair", static,
                                         method="histogram")
    t_keep = prune.prune_mask(tst.score, 0.5, "pair", static, method="histogram")[0].numpy()
    far = np.abs(j_score - thres) > 1e-6
    np.testing.assert_array_equal(t_keep[far], np.asarray(j_keep)[far])
    jeng.prune(jst, 0.5, "pair")
    teng.prune(tst, 0.5, "pair")
    valid = tst.cache.valid.numpy()
    assert valid.shape == (len(static), cfg.num_kv_heads, tst.cache.capacity)
    assert not valid[:, :, tst.sink:tst.prefill_len].all()
    far_static = np.ones(valid.shape, bool)
    far_static[:, :, tst.sink:tst.prefill_len] = far[list(static)]
    np.testing.assert_array_equal(valid[far_static], np.asarray(jst.cache.valid)[far_static])
    q = _query()
    for _ in range(2):
        assert teng.generate(q, tst) == jeng.generate(q, jst)


def test_hybrid_prune_ratio_counts_static_layers_only(engines, scored):
    jeng, teng = engines
    jst, tst = copy.deepcopy(scored)
    _, t_ratio = teng.prune(tst, 0.4, "pair")
    _, j_ratio = jeng.prune(jst, 0.4, "pair")
    assert 0.2 < t_ratio < 0.6 and abs(t_ratio - j_ratio) < 1e-3
    keep = prune.prune_mask(tst.score, 0.4, "pair", teng.config.static_layer_ids)[0]
    sliding = [l for l in range(teng.config.num_layers)
               if l not in teng.config.static_layer_ids]
    assert keep[sliding].all()


def test_hybrid_ring_memory_window_bound(engines, scored):
    _, teng = engines
    cfg = teng.config
    cache = scored[1].cache
    W = cache.window
    assert W == max(128, -(-cfg.sliding_window // 128) * 128) and W < cache.capacity
    L_s, L_t = cache.k_ring.shape[0], cache.k_static.shape[0]
    assert L_s + L_t == cfg.num_layers and cache.ring_pos.shape == (L_s, W)
    assert cache.ring_bytes() == L_s * cfg.num_kv_heads * W * cfg.head_dim * 2 * 4
    assert cache.mem_bytes() == cache.ring_bytes() + \
        L_t * cfg.num_kv_heads * cache.capacity * cfg.head_dim * 2 * 4
    assert scored[1].mem_gb() >= scored[1].used_gb() > 0


@pytest.mark.parametrize("pattern,layers", [(2, 4), (6, 7)])
def test_hybrid_ring_wraparound_matches_dense_and_reference(pattern, layers):
    """Logits of three query tokens after a 4 x 128 + 37-token prefill in
    chunks of 50: the ring (W 128) has wrapped four times."""
    cfg = tiny_config("gemma3", sliding_window_pattern=pattern, num_layers=layers)
    pcfg = _port_cfg(cfg)
    assert len(cfg.static_layer_ids) == {2: 2, 6: 1}[pattern]
    tree = seeded_tree(cfg, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree, "cpu", torch.float32)
    ids = np.random.default_rng(3).integers(1, cfg.vocab_size - 1, 4 * 128 + 37)
    q_ids = np.asarray([5, 7, 11])
    jc, tc = j_init_hybrid_cache(cfg, 1024, jnp.float32), init_hybrid_cache(pcfg, 1024,
                                                                            torch.float32, "cpu")
    for a in range(0, len(ids), 50):
        chunk = ids[a:a + 50]
        jc = j_forward_hybrid(jp, cfg, jnp.asarray(chunk, jnp.int32), jc).cache
        forward_hybrid(tp, pcfg, torch.from_numpy(chunk), tc)
    assert int(tc.ring_pos.max()) == len(ids) - 1 and int(tc.ring_pos.min()) > 2 * 128
    np.testing.assert_array_equal(tc.ring_pos.numpy(), np.asarray(jc.ring_pos))
    want = np.asarray(j_forward_hybrid(jp, cfg, jnp.asarray(q_ids, jnp.int32), jc,
                                       collect_logits="all").logits)
    got = forward_hybrid(tp, pcfg, torch.from_numpy(q_ids), tc, collect_logits="all").logits
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    dense = init_cache(pcfg, 1024, torch.float32, "cpu")
    full = transformer.forward(tp, pcfg, torch.from_numpy(np.concatenate([ids, q_ids])), dense,
                               collect_logits="all", attn_impl="dense").logits[-3:]
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-4)


def test_two_generates_on_one_state_agree_after_the_ring_wrapped(engines, scored):
    jeng, teng = engines
    _, tst = copy.deepcopy(scored)
    assert int(tst.cache.ring_pos.min()) >= 0  # the ring is full: it has wrapped
    before = snapshot(tst.cache)
    q = _query(4)
    first = teng.generate_ids(q, tst).tolist()
    for f, v in snapshot(tst.cache).items():
        assert torch.equal(v, before[f]), f
    assert teng.generate_ids(q, tst).tolist() == first
    assert first == teng.generate_ids(q, copy.deepcopy(scored[1])).tolist()


def test_captured_step_advance_leaves_the_ring_as_the_per_token_loop(engines, scored):
    """An eos inside a chunk of steps, update_cache=True: the steps after
    the answer ended write nothing into the rings."""
    _, teng = engines
    q = _query(5)
    out = []
    for fn in (Engine.generate_ids, generate_ids_per_token):
        st = copy.deepcopy(scored[1])
        toks = fn(teng, q, st).tolist()
        eos = next(t for i, t in enumerate(toks) if 1 <= i < 4 and t not in toks[:i])
        saved, teng.eos_ids = teng.eos_ids, (eos,)
        try:
            toks = fn(teng, q, st, update_cache=True).tolist()
        finally:
            teng.eos_ids = saved
        out.append((toks, snapshot(st.cache)))
    (t1, s1), (t2, s2) = out
    assert t1 == t2 and len(t1) < teng.max_new_tokens - 1
    for f in s1:
        assert torch.equal(s1[f], s2[f]), f


def _v1_tree(cfg):
    tree = seeded_tree(cfg, seed=4, scale=7.0)
    lp = jparams.quantize_layer_stacks(tree["layers"], jw4a8.quantize_weight_int4)
    return jax.device_get({**tree, "layers": lp})


def test_v1_w4a8_tree_through_the_hybrid_matches_reference(monkeypatch):
    cfg = tiny_config("gemma3")
    pcfg = _port_cfg(cfg)
    tree = _v1_tree(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree, "cpu", torch.float32)
    assert "q4" in tp["layers"]["wq"] and "s2" not in tp["layers"]["wq"]
    calls = []
    real = transformer.w4a8_linear
    monkeypatch.setattr(transformer, "w4a8_linear",
                        lambda x, w, b=None: calls.append(x.shape[0]) or real(x, w, b))
    ids = np.random.default_rng(5).integers(1, cfg.vocab_size - 1, 200)
    jc = j_init_hybrid_cache(cfg, 512, jnp.float32)
    tc = init_hybrid_cache(pcfg, 512, torch.float32, "cpu")
    for a, b in ((0, 160), (160, 161)):
        res = j_forward_hybrid(jp, cfg, jnp.asarray(ids[a:b], jnp.int32), jc,
                               collect_logits="all")
        jc, want = res.cache, np.asarray(res.logits)
        got = forward_hybrid(tp, pcfg, torch.from_numpy(ids[a:b]), tc,
                             collect_logits="all").logits.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    assert calls == [160] * 7 * cfg.num_layers + [1] * 7 * cfg.num_layers


def test_fused_w4a8_tree_raises_naming_the_v1_route():
    cfg = _port_cfg(tiny_config("gemma3"))
    eng = Engine("tiny-gemma3", config=cfg, tokenizer=IdTokenizer(512), dtype=torch.float32,
                 device="cpu", weight_quant="w4a8", **KW)
    assert "wqkv" in eng.params["layers"]
    with pytest.raises(ValueError, match="v1"):
        eng.prefill(_ctx(eng), prefill_chunk_size=256, do_score=False)


def test_hybrid_state_has_no_save_and_no_batch(engines, scored, tmp_path):
    _, teng = engines
    st = copy.deepcopy(scored[1])
    with pytest.raises(ValueError, match="pool"):
        teng.save_state(st, str(tmp_path / "s"))
    with pytest.raises(NotImplementedError, match="HybridKV"):
        serving.batched_generate_ids(teng, [_query()], [st], 4)


def test_command_line_engine_of_gemma3_is_retain(monkeypatch):
    """``cli.make_engine`` passes ``--kv_type evict`` on; the engine still
    forces retain for a gemma3 config."""
    from kvzip_tpu_torch import cli
    from kvzip_tpu_torch import engine as engine_module

    monkeypatch.setenv("KVZIP_PLATFORM", "cpu")
    monkeypatch.setattr(engine_module, "load_tokenizer",
                        lambda name, vocab_size=512: IdTokenizer(vocab_size))
    args = cli.build_parser().parse_args(["test", "-m", "tiny-gemma3", "--kv_type", "evict",
                                          "--dtype", "float32"])
    eng = cli.make_engine(args)
    assert eng.config.is_hybrid and eng.kv_type == "retain"
