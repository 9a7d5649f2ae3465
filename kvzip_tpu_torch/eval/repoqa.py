"""RepoQA function-retrieval scorer.

Semantics of reference `results/repo_qa_utils.py`: sanitize the model output
to the code block, compare against each candidate needle function with
smoothed sentence-BLEU, call it correct when the best match is the target
function and similarity >= threshold (pass@1 at 0.8).

The reference strips comments with tree-sitter (`repo_qa_utils.py:105-153`);
tree-sitter is not available in this environment, so stripping is
LEXER-GRADE instead: Python uses the stdlib ``tokenize`` (exact comment
tokens — identical to tree-sitter's comment nodes), and the C-like
languages use a string-literal-aware scanner (``//``, ``/* */``, with
backtick raw strings for go/typescript). A naive ``#.*``/``//.*`` regex
corrupts string literals ("color: #fff", URLs) — validated against a
fixture corpus in tests/test_harness.py. BLEU uses nltk when present,
else the native/pure fallback in this module.
"""

from __future__ import annotations

import io
import math
import re
import tokenize as _pytokenize
from collections import Counter
from typing import Dict, List


def sanitize_output(output: str) -> str:
    """Extract the code block if the model wrapped its answer in fences."""
    m = re.search(r"```[a-zA-Z0-9_+-]*\n(.*?)```", output, re.DOTALL)
    if m:
        return m.group(1)
    return output


def _strip_python_comments(source: str) -> str:
    """Exact comment removal via the Python lexer; falls back to a
    careful regex only if the snippet does not tokenize (truncated code)."""
    try:
        lines = source.splitlines(keepends=True)
        spans = []  # (row, col_start) -> cut to EOL
        for tok in _pytokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == _pytokenize.COMMENT:
                spans.append((tok.start[0] - 1, tok.start[1]))
        for row, col in spans:
            nl = "\n" if lines[row].endswith("\n") else ""
            lines[row] = lines[row][:col] + nl
        return "".join(lines)
    except Exception:
        return re.sub(r"(?m)(?<![\"'])#.*$", "", source)


def _strip_c_comments(source: str, raw_strings: bool = False) -> str:
    """String-aware // and /* */ removal (java/cpp/rust/typescript/go)."""
    out = []
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        if c in "\"'" or (raw_strings and c == "`"):
            quote = c
            out.append(c)
            i += 1
            while i < n:
                out.append(source[i])
                if source[i] == "\\" and quote != "`" and i + 1 < n:
                    out.append(source[i + 1])
                    i += 2
                    continue
                if source[i] == quote:
                    i += 1
                    break
                i += 1
            continue
        if c == "/" and i + 1 < n and source[i + 1] == "/":
            while i < n and source[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and source[i + 1] == "*":
            i += 2
            while i + 1 < n and not (source[i] == "*" and source[i + 1] == "/"):
                i += 1
            i = min(i + 2, n)
            continue
        out.append(c)
        i += 1
    return "".join(out)


def remove_comments(source: str, lang: str) -> str:
    if lang == "python":
        source = _strip_python_comments(source)
    elif lang in ("java", "cpp", "rust"):
        source = _strip_c_comments(source)
    elif lang in ("typescript", "go"):
        source = _strip_c_comments(source, raw_strings=True)
    return "\n".join(l for l in source.splitlines() if l.strip())


def _bleu_fallback(reference: List[str], candidate: List[str]) -> float:
    """Smoothed sentence-BLEU (method-4-like: 1/(c*ln) smoothing on zero
    counts); used when nltk is unavailable. Native C++ path preferred."""
    try:
        from kvzip_tpu_torch.native import sentence_bleu as native_bleu

        return native_bleu(reference, candidate)
    except Exception:
        pass
    if not candidate:
        return 0.0
    weights = [0.25] * 4
    p_logs = []
    for n in range(1, 5):
        cand_ngrams = Counter(tuple(candidate[i:i + n])
                              for i in range(len(candidate) - n + 1))
        ref_ngrams = Counter(tuple(reference[i:i + n])
                             for i in range(len(reference) - n + 1))
        overlap = sum((cand_ngrams & ref_ngrams).values())
        total = max(sum(cand_ngrams.values()), 1)
        if overlap == 0:
            # chen-cherry-like smoothing
            inv = 5 / math.log(len(candidate) + 1) if len(candidate) > 1 else 1
            p = 1.0 / (total * max(inv, 1))
        else:
            p = overlap / total
        p_logs.append(math.log(p))
    bp = 1.0 if len(candidate) > len(reference) else math.exp(
        1 - len(reference) / max(len(candidate), 1))
    return bp * math.exp(sum(w * pl for w, pl in zip(weights, p_logs)))


def compute_function_similarity(candidate: str, reference: str) -> float:
    cand_tokens = re.split(r"\s+", candidate.strip())
    ref_tokens = re.split(r"\s+", reference.strip())
    try:
        from nltk.translate.bleu_score import SmoothingFunction, sentence_bleu

        return sentence_bleu([ref_tokens], cand_tokens,
                             smoothing_function=SmoothingFunction().method4)
    except Exception:
        return _bleu_fallback(ref_tokens, cand_tokens)


def compute_pass_at_1(results: List[Dict], needle_by_repo: Dict,
                      threshold: float = 0.8,
                      ignore_comments: bool = False) -> float:
    """pass@1 at similarity threshold (reference THRESHOLDS[0.8])."""
    if not results:
        return 0.0
    correct = 0
    for res in results:
        output = sanitize_output(res["prediction"])
        if ignore_comments:
            output = remove_comments(output, res.get("lang", ""))
        best_name, best_sim = None, 0.0
        for needle in needle_by_repo.get(res["repo"], []):
            func = needle["needle"]
            if ignore_comments:
                func = remove_comments(func, res.get("lang", ""))
            sim = compute_function_similarity(output, func)
            if sim > best_sim:
                best_sim, best_name = sim, needle["name"]
        if best_name == res["func_name"] and best_sim >= threshold:
            correct += 1
    return correct / len(results)
