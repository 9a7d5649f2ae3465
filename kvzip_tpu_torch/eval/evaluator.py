"""Evaluator: full-cache vs pruned-cache comparison (reference `utils/tester.py`).

- ``generation``: regenerate with the pruned cache and compare strings;
- ``forward``: compare next-token probability distributions on the answer
  tokens — answer-prob deltas, top1-top2 margin shifts, flipped argmax list.
This is the golden-output harness the reference uses as its de-facto test
suite (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np


class Evaluator:

    def __init__(self, engine, inputs, info, verbose: bool = False):
        self.engine = engine
        self.inputs = inputs
        self.info = info
        self.verbose = verbose

    def __call__(self, state, generate: bool = True):
        results = {}
        for task in self.info.keys():
            self.print(f"\n* {task}")
            if generate:
                results[task] = self.generation(state, task)
            else:
                results[task] = self.forward(state, task)
        return results

    def decode(self, *a, **kw):
        return self.engine.decode(*a, **kw)

    def print(self, *a, **kw):
        if self.verbose:
            print(*a, **kw)

    def generation(self, state, task):
        output = self.engine.generate(self.inputs[task]["q"], state)
        ans = self.decode(self.inputs[task]["a"])
        gt = self.decode(self.inputs[task]["gt"])
        if output != ans:
            self.print(f"[ full] {ans}\n[prune] {output}\n")
        else:
            self.print("generation results not changed")
        return {"pruned": output, "full__": ans, "answer": gt}

    def forward(self, state, task):
        prob = np.asarray(self.info[task]["prob"])
        input_ids = np.concatenate(
            [self.inputs[task]["q"], self.inputs[task]["a"]])
        prob_prune = np.asarray(self.engine.prob(input_ids, state))
        label = np.asarray(self.inputs[task]["a"]).reshape(-1)
        return self._compare(prob, prob_prune, label)

    @staticmethod
    def _stat(x: np.ndarray):
        if x.size == 0:  # an answer of no tokens: nothing differs
            return (0.0, 0.0, 0.0)
        return (float(x.min()), float(np.abs(x).mean()), float(x.max()))

    def _compare(self, p1, p2, label):
        """reference `utils/tester.py:79-109` in numpy."""
        n = len(label)
        p1 = p1[-n - 1:-1]
        p2 = p2[-n - 1:-1]
        pred1, pred2 = p1.argmax(1), p2.argmax(1)
        pans1 = p1[np.arange(n), label]
        pans2 = p2[np.arange(n), label]

        result = {"p_ans": self._stat(pans2 - pans1)}

        top2_1 = np.sort(p1, axis=1)[:, -2:][:, ::-1]
        top2_2 = np.sort(p2, axis=1)[:, -2:][:, ::-1]
        margin1 = top2_1[:, 0] - top2_1[:, 1]
        margin2 = top2_2[:, 0] - top2_2[:, 1]
        diff_idx = np.nonzero(pred1 != pred2)[0]
        post_prev = p2[np.arange(n), pred1]
        margin2[diff_idx] = post_prev[diff_idx] - top2_2[diff_idx, 0]
        result["margin"] = self._stat(margin2 - margin1)

        result["idx_flip"] = diff_idx.tolist()
        result["idx_from"] = pred1[diff_idx].tolist()
        result["idx_to"] = pred2[diff_idx].tolist()
        result["p"] = self._stat(p2 - p1)

        if self.verbose:
            print("# prob diffs (pruned - full):",
                  {k: result[k] for k in ("p_ans", "margin", "p")})
            print(f"flipped predictions: {len(diff_idx)}")
        return result
