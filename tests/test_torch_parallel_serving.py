"""The replica mesh and data-parallel serving, the command line's ``--tp``
and the port's dry run, on the CPU over gloo: the cases of
``tests/test_parallel_replica.py`` and the legs of
``__graft_entry__.py::dryrun_multichip``.

One gloo group of four spawned ranks (``torch_parallel_ranks.
serving_cases``, no JAX) runs the replica mesh and then the dry run; the
reference runs in this process single-device on the same weights and ids
(its replica mesh equals it to its own test's tolerance):

- ("replica", "data", "model") = (2, 1, 2) in four ranks, compaction
  (``flat_decode="off"``): scores within 1e-4, probabilities within 1e-4;
  ``batched_generate_ids`` of four requests over two states splits over
  the two batch shards (replica x data) and every rank returns the
  reference's four greedy answers;
- the dry run's legs 1, 2, 3b and 4 at four ranks (shorter contexts than
  the module's default): the ring and the pool-TP legs answer as leg 1;
- ``cli test --tp 2`` in two gloo ranks (``KVZIP_PLATFORM=cpu``, the
  environment torchrun gives): both ranks run it, rank 0 prints, rank 1's
  output is silenced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from kvzip_tpu.config import tiny_config as jtiny
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.models import params as jparams
from kvzip_tpu.tokenizer import ByteTokenizer
from kvzip_tpu_torch.config import tiny_config
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.parallel import dryrun

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_parallel import CTX, QUESTION, TOL, _answer_ids, _whole


@pytest.fixture(scope="module")
def reference():
    jcfg = jtiny("llama")
    tree = jax.device_get(jparams.init_params(jcfg, jax.random.PRNGKey(11), jnp.float32))
    jeng = JEngine("tiny-llama", kv_type="evict", config=jcfg,
                   params=jax.tree_util.tree_map(jnp.asarray, tree), dtype=jnp.float32,
                   tokenizer=ByteTokenizer(jcfg.vocab_size), max_new_tokens=6,
                   decode_budget=256, capacity_granularity=256, score_chunk_size=256,
                   flat_decode="off")
    ctx, query = jeng.encode(CTX), jeng.apply_template(QUESTION)
    ctxs = [ctx[40:], ctx[117:]]
    jst = jeng.prefill(ctx, prefill_chunk_size=300)
    out = dict(score=np.asarray(jst.score))
    jeng.prune(jst, 0.5, "pair")
    out["prob"] = jeng.prob(query, jst)
    answers = []
    for c in ctxs:
        s = jeng.prefill(c, prefill_chunk_size=300)
        jeng.prune(s, 0.5, "pair")
        jeng.max_new_tokens = 5
        answers.append(_answer_ids(jeng, s, query))
    out["batched"] = answers * 2
    cases = {"replica": dict(cfg=tiny_config("llama"), ctx=ctx, ctxs=ctxs, query=query,
                             params=params_from_jax(tree, "cpu", torch.float32))}
    return out, cases


@pytest.fixture(scope="module")
def ranks_out(reference):
    return dryrun.spawn(4, ranks.serving_cases, reference[1])


def test_replica_mesh_matches_reference(reference, ranks_out):
    want = reference[0]
    for r in ranks_out:
        assert r["axes"] == ("replica", "data", "model")
        assert r["shape"] == {"replica": 2, "data": 1, "model": 2}
        np.testing.assert_allclose(r["prob"], want["prob"], atol=TOL, rtol=0)
    np.testing.assert_allclose(_whole(ranks_out, "score"), want["score"], rtol=TOL, atol=TOL)


def test_data_parallel_batched_generate(reference, ranks_out):
    for r in ranks_out:
        assert [a.tolist() for a in r["batched"]] == reference[0]["batched"]


def test_dryrun_legs(ranks_out):
    for r in ranks_out:
        legs = r["legs"]
        assert legs["leg2"] == legs["leg1"] == legs["leg3b"]
        assert len(legs["leg4"]) == 3
        assert legs == ranks_out[0]["legs"]


def test_cli_test_tp2(tmp_path):
    argv = ["test", "-m", "tiny-llama", "-d", "gsm", "--dtype", "float32", "--tp", "2"]
    got = dryrun.spawn(2, ranks.cli_ranks, str(tmp_path), argv)
    assert "generation at ratio 0.3" in got[0]["out"] and not got[0]["silenced"]
    assert got[1]["out"] == "" and got[1]["silenced"]
