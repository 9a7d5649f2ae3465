"""DataWrapper: bind a dataset to the engine (reference `data/wrapper.py`).

Generates full-cache reference answers + next-token probability tensors per
task for later full-vs-pruned comparison by the Evaluator.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Union

import numpy as np


def get_query(task: str, q=None) -> str:
    if task == "repeat":
        return "Repeat the previous context exactly."
    if task == "qa":
        if q is None:
            return "Q: Answer the question based on the previous context."
        return f"Q: {q}"
    if task == "reason":
        return ("Reason and answer the question. You must say the answer in "
                "the last sentence beginning with 'The answer is'. Q: " + str(q))
    if task == "summarize":
        return "Please summarize the previous context."
    raise ValueError(f"Invalid task: {task}")


class DataWrapper:

    def __init__(self, dataname: str, dataset, engine):
        self.name, self.dataset, self.engine = dataname, dataset, engine
        engine.set_chat_template(dataname)

    def __len__(self):
        return len(self.dataset)

    def prefill_context(self, idx: int, load_score: bool = False):
        data = self.dataset[idx]
        ctx_ids = self.engine.encode(data["context"])
        state = self.engine.prefill(ctx_ids, load_score=load_score)
        print(f"# prefill {self.engine.name} {self.name}-{idx}: "
              f"{len(ctx_ids)} tokens, KV cache {state.mem_gb()} GB")
        return state

    def _prepare_query(self, data, state, inputs, task: str):
        if task in ("qa", "reason"):
            for i, (q, gt) in enumerate(zip(data["question"], data["answers"])):
                q_ids = self.engine.apply_template(get_query(task, q))
                a = self.engine.generate(q_ids, state)
                a_ids = self.engine.encode(a)
                gt_ids = self.engine.encode(gt)
                tag = f"qa-{i}" if i > 0 else "qa"
                inputs[tag] = {"q": q_ids, "a": a_ids, "gt": gt_ids}
                inputs["eval_task"].append(tag)
                print(f"[QA {i}] {a!r} | {gt!r}")
        else:
            q_ids = self.engine.apply_template(get_query(task))
            if task == "repeat":
                a_ids = state.ctx_ids
            else:
                a = self.engine.generate(q_ids, state)
                a_ids = self.engine.encode(a)
            inputs[task] = {"q": q_ids, "a": a_ids, "gt": a_ids}
            if "scbench" not in self.name and len(a_ids) < 512:
                inputs["eval_task"].append(task)

    def generate_answer(self, idx: int, state):
        """Full-cache answers + prob tensors (reference `data/wrapper.py:84-106`)."""
        data = self.dataset[idx]
        eval_task = ["reason"] if "gsm" in self.name else ["qa"]

        inputs = defaultdict(list)
        for task in eval_task:
            self._prepare_query(data, state, inputs, task)

        info = defaultdict(dict)
        for fmt in inputs["eval_task"]:
            input_ids = np.concatenate([inputs[fmt]["q"], inputs[fmt]["a"]])
            info[fmt]["prob"] = self.engine.prob(input_ids, state)
        return inputs, info
