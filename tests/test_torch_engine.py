"""The port's main path as a whole against the reference engine: the same
tiny config, weights and token ids through prefill, scoring, pair prune
into the pool, and greedy decode, in float32 on the CPU.

The reference runs with ``flat_decode="on"`` so that it, like the port,
builds the pool on the CPU. Tolerances: scores atol = rtol = 1e-5; keep
masks identical except within 1e-6 of the threshold; greedy tokens
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu import prune as jprune
from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.tokenizer import ByteTokenizer
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch import prune
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.models.params import params_from_jax

CTX = ("The archive keeps its ledgers in the north tower. " * 12
       + "The courier's password is heliotrope. "
       + "Filler sentences pad the context to a longer length here. " * 14)
QUERY = "What is the password?"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run with one torch thread a module: the test
    runner's workers share the machine's cores, and each worker's torch
    thread pool sized to all of them multiplies its time by several (a
    timed run of the engine files: 218 s with the default threads, 77 s
    with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class IdTokenizer(ByteTokenizer):
    """Bytes in, token ids out: decode prints every id, so two answers
    compare token for token."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in np.asarray(ids).reshape(-1))


def _engines():
    jcfg = tiny_config("llama", head_dim=128, num_heads=4, num_kv_heads=2,
                       hidden_size=128)
    tcfg = tconfig.tiny_config("llama", head_dim=128, num_heads=4,
                               num_kv_heads=2, hidden_size=128)
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(0),
                                              jnp.float32))
    # weights at 7x the init scale: the default tiny model answers every
    # query with one repeated token, which would hide a wrong attention
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][name] = tree["layers"][name] * np.float32(7.0)
    kw = dict(tokenizer=IdTokenizer(jcfg.vocab_size), max_new_tokens=8,
              decode_budget=136, capacity_granularity=256,
              score_chunk_size=256)
    jeng = JEngine("tiny-llama", config=jcfg,
                   params=jax.tree_util.tree_map(jnp.asarray, tree),
                   dtype=jnp.float32, flat_decode="on", **kw)
    teng = Engine("tiny-llama", config=tcfg,
                  params=params_from_jax(tree, "cpu", torch.float32),
                  dtype=torch.float32, device="cpu", **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _engines()


def test_scores_masks_and_greedy_tokens_match_reference(engines):
    jeng, teng = engines
    jst = jeng.prefill(CTX, prefill_chunk_size=300)
    tst = teng.prefill(CTX, prefill_chunk_size=300)
    assert tst.sink == jst.sink and tst.ctx_len == jst.ctx_len
    j_score = np.asarray(jst.score)
    t_score = tst.score.numpy()
    np.testing.assert_allclose(t_score, j_score, rtol=1e-5, atol=1e-5)

    # the dense-cache answer (before any prune)
    assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)

    j_keep, thres, _ = jprune.prune_mask(jnp.asarray(j_score), 0.3, "pair",
                                         method="histogram")
    t_keep, _, _ = prune.prune_mask(tst.score, 0.3, "pair", method="histogram")
    far = np.abs(j_score - thres) > 1e-6
    np.testing.assert_array_equal(t_keep.numpy()[far], np.asarray(j_keep)[far])

    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    np.testing.assert_array_equal(tst.cache.lengths.numpy(),
                                  np.asarray(jst.cache.lengths))
    # two successive answers: the second runs after the O(1) restore
    for _ in range(2):
        assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)
    assert tst.cache.tail_len == 0


def test_multi_turn_with_refold_matches_reference(engines):
    jeng, teng = engines
    jst = jeng.prefill(CTX, prefill_chunk_size=300)
    tst = teng.prefill(CTX, prefill_chunk_size=300)
    jeng.prune(jst, 0.3, "pair")
    teng.prune(tst, 0.3, "pair")
    for turn in range(7):
        q = f"Turn {turn}: and then?"
        assert teng.generate(q, tst, update_cache=True) == \
            jeng.generate(q, jst, update_cache=True)
    assert tst.refolds >= 1
    assert teng.generate(QUERY, tst) == jeng.generate(QUERY, jst)
