"""The port's golden-compare harness (``kvzip_tpu_torch/data``, ``eval``,
``utils``) against ``kvzip_tpu``'s, on the CPU.

Held exactly: answer normalization, the metric family, ``evaluate_answer``
on every dataset route (with ``rouge``/``nltk`` importable and with both
refused, so that the native and pure-Python scorers the card's machine
runs are compared too), the RepoQA scorer, the dataset records, the
queries and generation lengths, ``save_result``'s file and the NIAH
score grid. On one tiny float32 engine pair (the reference's weights
carried by ``params_from_jax``, gsm contexts cut to 300 characters as in
``tests/test_harness.py``): ``DataWrapper.generate_answer``'s token ids
equal and its next-token probabilities within 1e-5; then, both retain
states pruned with the reference's scores at two ratios, ``Evaluator``'s
generation strings equal and its forward comparison's flipped positions
equal, its statistics within 1e-5 (float32 sums in another order).
"""

import builtins
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvzip_tpu.config import tiny_config
from kvzip_tpu.data import DataWrapper as JDataWrapper
from kvzip_tpu.data import get_query as jget_query
from kvzip_tpu.data import load_dataset_all as jload
from kvzip_tpu.engine import Engine as JEngine
from kvzip_tpu.eval import Evaluator as JEvaluator
from kvzip_tpu.eval import metrics as jmetrics
from kvzip_tpu.eval import needle_viz as jviz
from kvzip_tpu.eval import repoqa as jrepoqa
from kvzip_tpu.models import params as jparams
from kvzip_tpu.tokenizer import ByteTokenizer
from kvzip_tpu.utils import io as jio
from kvzip_tpu_torch import config as tconfig
from kvzip_tpu_torch.data import DataWrapper, get_query, load_dataset_all
from kvzip_tpu_torch.engine import Engine
from kvzip_tpu_torch.eval import Evaluator, metrics, needle_viz, repoqa
from kvzip_tpu_torch.models.params import params_from_jax
from kvzip_tpu_torch.utils import TimeStamp, device_mem_gb, io
from kvzip_tpu_torch.utils.profiling import profile_trace

from test_torch_engine import one_torch_thread  # noqa: F401

PROB_ATOL = 1e-5

PAIRS = [
    ("The  Answer is: Seven!", "answer is 7"),
    ("the cat sat", "a cat sat"),
    ("well the answer is paris.", "Paris"),
    ("has a and c", "a, b, c"),
    ("so we get 42", "work...\n#### 42"),
    ("(B) the second option", "(B) second option"),
    ("(C)", "(B) second option"),
    ("second option", "(B) second option"),
    ("value-0012345678", "value-0012345678"),
    ("", "x"),
    ("one two three four five</s>", "two three four six"),
    ("The archive keeps its ledgers; the north tower.", "The north tower keeps the ledgers"),
]


@pytest.fixture(params=["present", "refused"])
def scorers(request, monkeypatch):
    """``rouge`` and ``nltk`` importable, or refused to both packages (the
    card's machine has neither: the native and pure-Python paths)."""
    if request.param == "refused":
        real = builtins.__import__

        def refuse(name, *a, **kw):
            if name.split(".")[0] in ("rouge", "nltk"):
                raise ImportError(f"{name} refused by the test")
            return real(name, *a, **kw)
        monkeypatch.setattr(builtins, "__import__", refuse)
    return request.param


@pytest.mark.parametrize("fn", ["f1_score", "include_score", "include_score_multi",
                                "include_score_gsm", "include_score_manyshot",
                                "exact_match_score"])
def test_metric_family(fn):
    for pred, ref in PAIRS:
        for norm in (True, False):
            assert (getattr(metrics, fn)(pred, ref, normalize=norm)
                    == getattr(jmetrics, fn)(pred, ref, normalize=norm)), (pred, ref, norm)


def test_normalize_and_rouge(scorers):
    for pred, ref in PAIRS:
        assert metrics.normalize_answer(pred) == jmetrics.normalize_answer(pred)
        assert metrics.rouge_l_f(pred, ref) == jmetrics.rouge_l_f(pred, ref)
        if pred.strip():
            assert metrics.rouge_score(pred, ref) == jmetrics.rouge_score(pred, ref)


FUNCS = {
    "a": "def add(a, b):\n    # sum\n    return a + b\n",
    "b": "def mul(a, b):\n    return a * b  # product\n",
    "c": "def neg(x):\n    s = '# not a comment'\n    return -x\n",
}


def _repoqa_refs():
    return {"lang": "python", "repo": "demo", "func_name": ["add", "mul", "neg", "add"],
            "ground_truth": [FUNCS["a"], FUNCS["b"], FUNCS["c"], FUNCS["a"]]}


def _repoqa_preds():
    return [f"```python\n{FUNCS['a']}```", FUNCS["b"].replace("*", "+"),
            f"Here it is:\n```\n{FUNCS['c']}```</s>", ""]


ROUTES = ["squad", "gsm", "needle", "scbench_kv", "scbench_vt", "scbench_mf",
          "scbench_many_shot", "scbench_summary", "scbench_qa_eng", "scbench_choice_eng",
          "scbench_repoqa", "scbench_repoqa_and_kv"]


@pytest.mark.parametrize("name", ROUTES)
def test_evaluate_answer_routes(name, scorers):
    if "repoqa" in name:
        preds, refs = _repoqa_preds(), _repoqa_refs()
        sub = ["repoqa", "kv", "repoqa", "kv"] if "and_kv" in name else None
        args = [(preds, refs, name, "qa", False, sub)]
    else:
        preds, refs = [p for p, _ in PAIRS], [r for _, r in PAIRS]
        args = [(preds, refs, name, fmt, sim, None)
                for fmt in ("qa", "summarize") for sim in (False, True)]
        args.append((preds, refs, "squad", "qa", False, [name] * len(PAIRS)))
    for a in args:
        assert metrics.evaluate_answer(*a[:4], similarity=a[4], subtask=a[5]) == \
            jmetrics.evaluate_answer(*a[:4], similarity=a[4], subtask=a[5]), a[2:]


def test_repoqa_scorer(scorers):
    for lang in ("python", "java", "cpp", "rust", "typescript", "go", "other"):
        for src in (*FUNCS.values(), 'var s = "http://x" // c\n/* b */ x = `//raw`;'):
            assert repoqa.remove_comments(src, lang) == jrepoqa.remove_comments(src, lang)
    for p in _repoqa_preds():
        assert repoqa.sanitize_output(p) == jrepoqa.sanitize_output(p)
        for f in FUNCS.values():
            assert (repoqa.compute_function_similarity(p, f)
                    == jrepoqa.compute_function_similarity(p, f))
    refs = _repoqa_refs()
    needles = {"demo": [{"needle": g, "name": n}
                        for n, g in zip(refs["func_name"], refs["ground_truth"])]}
    results = [{"prediction": p, "lang": "python", "repo": "demo", "func_name": n,
                "ground_truth": g}
               for p, n, g in zip(_repoqa_preds(), refs["func_name"], refs["ground_truth"])]
    for ignore in (False, True):
        got = repoqa.compute_pass_at_1(results, needles, ignore_comments=ignore)
        assert got == jrepoqa.compute_pass_at_1(results, needles, ignore_comments=ignore)
        assert got > 0


def test_queries_and_generation_lengths():
    for task in ("repeat", "qa", "reason", "summarize"):
        for q in (None, "What is it?"):
            if task == "reason" and q is None:
                continue
            assert get_query(task, q) == jget_query(task, q)
    with pytest.raises(ValueError):
        get_query("translate")
    for name in ("needle", "scbench_mf", "squad", "scbench_summary", "gsm",
                 "scbench_repoqa", "scbench_kv"):
        assert io.set_gen_length(name) == jio.set_gen_length(name)


@pytest.mark.parametrize("name", ["needle", "gsm", "squad", "scbench_kv_tiny"])
def test_dataset_records(name, monkeypatch, capsys):
    """The same records from both packages under a ByteTokenizer; offline
    (the hosted sets fail over to their synthetic stand-ins at once), and
    the port's "loaded" line says so."""
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    tok = ByteTokenizer()
    got = load_dataset_all(name, tok, n_data=4)
    assert got == jload(name, tok, n_data=4)
    out = capsys.readouterr().out
    assert ("synthetic stand-in" in out) == (name != "needle")


def test_save_result_and_needle_grid(tmp_path):
    """One sweep's outputs saved by both packages (12 needle samples) give
    the same files, and the same NIAH score grid at each ratio."""
    answer = "Eat a sandwich and sit in Dolores Park on a sunny day."
    for i in range(12):
        outputs = {"qa": [[[r, r, 0.5], {"pruned": answer if r > 0.1 * i else "no",
                                         "full__": answer, "answer": answer}]
                          for r in (0.9, 0.5, 0.3)]}
        got = io.save_result(outputs, "needle", i, "m", root=str(tmp_path / "port"))
        want = jio.save_result(outputs, "needle", i, "m", root=str(tmp_path / "ref"))
        assert open(got).read() == open(want).read()
    for r in (0.9, 0.5, 0.3):
        a = needle_viz.collect_scores(str(tmp_path / "port"), "m", ratio=r)
        np.testing.assert_array_equal(a, jviz.collect_scores(str(tmp_path / "ref"), "m",
                                                             ratio=r))


def test_profiling_on_the_cpu(tmp_path, capsys):
    """No card in use: memory (0, 0), no synchronize; the trace is written."""
    assert device_mem_gb() == (0.0, 0.0)
    tt = TimeStamp(verbose=True)
    tt("phase")
    assert "Mem: 0.00/0.00 GB. [phase]" in capsys.readouterr().out
    with profile_trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


# ------------------------------------------------------------ engine pair
KW = dict(max_new_tokens=6, decode_budget=256, capacity_granularity=256,
          score_chunk_size=256)


@pytest.fixture(scope="module")
def pair():
    """(reference engine, port engine, dataset) on the same weights: retain
    caches, float32, gsm contexts cut to 300 characters."""
    cfg = tiny_config("llama")
    tree = jax.device_get(jparams.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))
    tok = ByteTokenizer(cfg.vocab_size)
    jeng = JEngine("tiny-llama", kv_type="retain", config=cfg, tokenizer=tok,
                   params=jax.tree_util.tree_map(jnp.asarray, tree), dtype=jnp.float32, **KW)
    teng = Engine("tiny-llama", kv_type="retain", config=tconfig.tiny_config("llama"),
                  params=params_from_jax(tree, "cpu", torch.float32), tokenizer=tok,
                  dtype=torch.float32, device="cpu", **KW)
    ds = [dict(d, context=d["context"][:300]) for d in jload("gsm", tok, n_data=2)]
    return jeng, teng, ds


def _same_stats(got, want):
    assert got["idx_flip"] == want["idx_flip"]
    assert got["idx_from"] == want["idx_from"] and got["idx_to"] == want["idx_to"]
    for k in ("p_ans", "margin", "p"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PROB_ATOL, err_msg=k)


def test_golden_compare_against_reference(pair):
    jeng, teng, ds = pair
    jw, tw = JDataWrapper("gsm", ds, jeng), DataWrapper("gsm", ds, teng)
    jst, tst = jw.prefill_context(0), tw.prefill_context(0)
    jin, jinfo = jw.generate_answer(0, jst)
    tin, tinfo = tw.generate_answer(0, tst)
    assert list(tin["eval_task"]) == list(jin["eval_task"]) == ["qa"]
    for k in ("q", "a", "gt"):
        np.testing.assert_array_equal(tin["qa"][k], jin["qa"][k], err_msg=k)
    p_t, p_j = tinfo["qa"]["prob"], np.asarray(jinfo["qa"]["prob"])
    assert p_t.shape == p_j.shape
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=PROB_ATOL)

    # both prune with the reference's scores, so the kept rows are the same
    tst.score = torch.tensor(np.asarray(jst.score), dtype=torch.float32)
    jev, tev = JEvaluator(jeng, jin, jinfo), Evaluator(teng, tin, tinfo)
    for ratio in (0.8, 0.4):
        jthres, jtrue = jeng.prune(jst, ratio, "pair")
        tthres, ttrue = teng.prune(tst, ratio, "pair")
        assert (tthres, ttrue) == pytest.approx((jthres, jtrue), abs=1e-6)
        assert tev(tst, generate=True) == jev(jst, generate=True)
        got, want = tev(tst, generate=False), jev(jst, generate=False)
        assert list(got) == list(want) == ["qa"]
        _same_stats(got["qa"], want["qa"])


def test_compare_rule_on_crafted_distributions():
    """``Evaluator._compare`` on the same probabilities, with flips and
    margins, gives the reference's result exactly."""
    rng = np.random.default_rng(3)
    p1 = rng.dirichlet(np.ones(32) * 0.3, size=12).astype(np.float32)
    p2 = p1.copy()
    p2[3:7] = rng.dirichlet(np.ones(32) * 0.3, size=4)
    label = rng.integers(0, 32, 10)
    got = Evaluator(None, {}, {})._compare(p1, p2, label)
    assert got == JEvaluator(None, {}, {})._compare(p1, p2, label)
    assert got["idx_flip"]


def test_compare_on_an_answer_of_no_tokens():
    """Random weights answer in ids the byte tokenizer cannot spell, so the
    answer's text round trip can leave no token. The reference's
    ``_compare`` raises there (numpy's minimum of an empty array); the
    port's reports that nothing differs (``ROADMAP.md`` queue 3)."""
    p = np.full((5, 8), 1 / 8, np.float32)
    none = np.zeros(0, np.int64)
    got = Evaluator(None, {}, {})._compare(p, p, none)
    zero = (0.0, 0.0, 0.0)
    assert got == dict(p_ans=zero, margin=zero, idx_flip=[], idx_from=[], idx_to=[], p=zero)
    with pytest.raises(ValueError, match="zero-size"):
        JEvaluator(None, {}, {})._compare(p, p, none)


def test_generation_length_set_after_the_engine(pair):
    """``set_gen_length`` changes ``max_new_tokens`` after ``__init__`` fixed
    ``decode_budget``: the state's captured step takes the new length (its
    budget is a device tensor set each answer), and the room check still
    refuses a length the cache cannot hold."""
    _, teng, ds = pair
    st = teng.prefill(teng.encode(ds[0]["context"]), do_score=False)
    q = teng.apply_template("Q: go on")
    eos, teng.eos_ids = teng.eos_ids, (-1,)
    try:
        assert len(teng.generate_ids(q, st)) == KW["max_new_tokens"]
        step = teng.decode_step(st)
        assert io.set_gen_length("needle", teng) == 32
        assert len(teng.generate_ids(q, st)) == 32 and teng.decode_step(st) is step
        teng.max_new_tokens = 2000
        with pytest.raises(ValueError, match="capacity"):
            teng.generate_ids(q, st)
    finally:
        teng.eos_ids, teng.max_new_tokens = eos, KW["max_new_tokens"]
