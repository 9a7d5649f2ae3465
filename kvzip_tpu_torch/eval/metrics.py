"""Answer metrics — parity with reference `results/metric.py` (SCBench-derived).

rouge-L and sentence-BLEU run through the native C++ extension
(`kvzip_tpu_torch.native`) when built, with pure-Python fallbacks; scoring large
ratio sweeps is metric-bound, which is why the hot loops are native.
"""

from __future__ import annotations

import re
import string
from collections import Counter, defaultdict
from typing import List, Optional

from kvzip_tpu_torch.eval import repoqa

_WORD_NUM = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
}
_NUM_RE = re.compile(r"\b(" + "|".join(_WORD_NUM) + r")\b")


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    s = " ".join(s.split())
    return _NUM_RE.sub(lambda m: _WORD_NUM[m.group()], s)


def lcs_length(a: List[str], b: List[str]) -> int:
    """Token-level longest common subsequence (native if available)."""
    try:
        from kvzip_tpu_torch.native import lcs_length as native_lcs

        return native_lcs(a, b)
    except Exception:
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for x in a:
            cur = [0]
            for j, y in enumerate(b):
                cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
            prev = cur
        return prev[-1]


def rouge_l_f(prediction: str, ground_truth: str) -> float:
    """rouge-L F1 on whitespace tokens (reference uses `rouge` pkg rouge-l f)."""
    pred = prediction.split()
    ref = ground_truth.split()
    if not pred or not ref:
        return 0.0
    lcs = lcs_length(pred, ref)
    if lcs == 0:
        return 0.0
    p, r = lcs / len(pred), lcs / len(ref)
    return 2 * p * r / (p + r)


def rouge_score(prediction: str, ground_truth: str, **kw) -> float:
    try:
        from rouge import Rouge

        return Rouge().get_scores([prediction], [ground_truth],
                                  avg=True)["rouge-l"]["f"]
    except Exception:
        return rouge_l_f(prediction, ground_truth)


def f1_score(pred: str, ref: str, normalize: bool = True) -> float:
    if normalize:
        pred, ref = normalize_answer(pred), normalize_answer(ref)
    pt, rt = pred.split(), ref.split()
    common = Counter(pt) & Counter(rt)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pt)
    recall = num_same / len(rt)
    return 2 * precision * recall / (precision + recall)


def include_score(pred: str, ref: str, normalize: bool = True) -> float:
    if normalize:
        pred, ref = normalize_answer(pred), normalize_answer(ref)
    return float(ref in pred)


def include_score_multi(pred: str, ref: str, normalize: bool = True) -> float:
    refs = ref.split(", ")
    if normalize:
        pred = normalize_answer(pred)
        refs = [normalize_answer(r) for r in refs]
    return sum(r in pred for r in refs) / len(refs)


def include_score_gsm(pred: str, ref: str, normalize: bool = True) -> float:
    ref = ref.strip().split("#### ")[-1]
    if normalize:
        pred, ref = normalize_answer(pred), normalize_answer(ref)
    return float(ref in pred)


def include_score_manyshot(pred: str, ref: str, normalize: bool = True) -> float:
    if "(" in pred and "(" in ref:
        p = pred.split("(")[1].split(")")[0]
        r = ref.split("(")[1].split(")")[0]
        return float(p == r)
    if ref and ref[0] == "(":
        ref = ref.split(")")[1].strip()
    if normalize:
        pred, ref = normalize_answer(pred), normalize_answer(ref)
    return float(ref in pred)


def exact_match_score(pred: str, ref: str, normalize: bool = True) -> float:
    if normalize:
        pred, ref = normalize_answer(pred), normalize_answer(ref)
    return float(pred == ref)


def repoqa_pass_at_1(preds, refs, subtask=None) -> float:
    """repoqa: function-retrieval similarity pass@1 (reference
    `results/repo_qa_utils.py` via tree-sitter; here regex extraction +
    BLEU similarity — see eval/repoqa.py)."""
    needle_by_repo = defaultdict(list)
    for name, gt in zip(refs["func_name"], refs["ground_truth"]):
        needle_by_repo[refs["repo"]].append({"needle": gt, "name": name})
    results = []
    for idx in range(len(preds)):
        if subtask is not None and "repoqa" not in subtask[idx]:
            continue
        pred = preds[idx]
        if pred.endswith("</s>"):
            pred = pred[:-4]
        if not pred.strip():
            continue
        results.append({
            "prediction": pred, "lang": refs["lang"], "repo": refs["repo"],
            "func_name": refs["func_name"][idx],
            "ground_truth": refs["ground_truth"][idx]})
    return repoqa.compute_pass_at_1(results, needle_by_repo, threshold=0.8)


def evaluate_answer(preds, refs, dataname: str, format: str,
                    similarity: bool = False, subtask=None):
    """Dataset-routed scoring (reference `results/metric.py:156-228`)."""
    score: List[float] = []
    if "repoqa" in dataname and not similarity:
        if "repoqa_and_kv" in dataname:
            for i, (pred, ref) in enumerate(zip(preds, refs["ground_truth"])):
                if pred.endswith("</s>"):
                    pred = pred[:-4]
                if not pred.strip():
                    score.append(0.0)
                    continue
                if subtask is not None and "kv" in subtask[i]:
                    score.append(include_score(pred, ref))
            kv_avg = sum(score) / len(score) if score else 0.0
            return [kv_avg, repoqa_pass_at_1(preds, refs, subtask)]
        return [repoqa_pass_at_1(preds, refs)]

    for i, (pred, ref) in enumerate(zip(preds, refs)):
        if pred.endswith("</s>"):
            pred = pred[:-4]
        if not pred.strip():
            score.append(0.0)
            continue
        name = subtask[i] if subtask is not None else dataname
        if similarity:
            score.append(f1_score(pred, ref))
        elif format != "qa":
            score.append(rouge_score(pred, ref))
        elif "_vt" in name:
            score.append(include_score_multi(pred, ref, normalize=False))
        elif "_mf" in name:
            score.append(exact_match_score(pred, ref, normalize=False))
        elif "_many_shot" in name:
            score.append(include_score_manyshot(pred, ref))
        elif "summary" in name:
            score.append(rouge_score(pred, ref))
        elif "qa_eng" in name:
            score.append(max(f1_score(pred, ref), include_score(pred, ref)))
        elif "choice_eng" in name:
            score.append(include_score(pred.split("\n")[0], ref))
        elif "gsm" in name:
            pred = pred.strip().lower().split("the answer is ")[-1]
            score.append(include_score_gsm(pred, ref, normalize=False))
        else:
            score.append(include_score(pred, ref))
    return score
