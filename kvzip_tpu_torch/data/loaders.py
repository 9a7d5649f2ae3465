"""Dataset loaders — parity with reference `data/load.py`.

Record format: ``{"context": str, "question": List[str], "answers": List[str]}``.
Datasets: squad, needle (NIAH), gsm, scbench_* (incl. _tiny/_short/_mid tags).

Network access is attempted for the HF-hosted sets (squad / gsm8k /
Jang-Hyun/SCBench-preprocessed) exactly as the reference does; in air-gapped
environments a deterministic synthetic fallback with the same record shape
keeps every pipeline (eval CLI, tests, benches) runnable. The "loaded" line
says when the records are that stand-in, so that no result taken on them
passes for the hosted set's.
"""

from __future__ import annotations

import random
from typing import List, Tuple

from kvzip_tpu_torch.data.needle import NeedleHaystack, synthetic_haystack

SCBENCH_TAGS = [
    "many_shot", "mf", "repoqa", "choice_eng", "prefix_suffix", "summary",
    "qa_eng", "vt", "kv", "summary_with_needles", "repoqa_and_kv",
]


def load_dataset_all(name: str, tokenizer, n_data: int = 100,
                     allow_synthetic: bool = True) -> List[dict]:
    synthetic = False
    if name == "squad":
        ds, synthetic = _load_squad(n_data, allow_synthetic)
    elif name == "needle":
        ds = _load_niah(tokenizer)
    elif name == "gsm":
        ds, synthetic = _load_gsm(tokenizer, n_data, allow_synthetic)
    elif "scbench" in name:
        ds, synthetic = _load_scbench(name, allow_synthetic)
    else:
        raise ValueError(f"Invalid dataset: {name}")
    print(f"\n{name} loaded, #data: {len(ds)}"
          + (" (synthetic stand-in: the hosted set could not be loaded)"
             if synthetic else ""))
    return ds


# --------------------------------------------------------------------- squad
def _load_squad(n_data: int, allow_synthetic: bool) -> Tuple[List[dict], bool]:
    try:
        from datasets import load_dataset

        data = load_dataset("rajpurkar/squad", split="train")
        pool = {}
        out: List[dict] = []
        for d in data:
            ctx = d["context"]
            if ctx not in pool:
                pool[ctx] = len(out)
                out.append({"context": ctx, "question": [d["question"]],
                            "answers": [d["answers"]["text"][0]]})
            else:
                rec = out[pool[ctx]]
                rec["question"].append(d["question"])
                rec["answers"].append(d["answers"]["text"][0])
            if len(pool) > n_data:
                break
        return out, False
    except Exception:
        if not allow_synthetic:
            raise
        return _synthetic_qa(n_data, seed=0), True


def _synthetic_qa(n_data: int, seed: int) -> List[dict]:
    """Deterministic extractive-QA records: facts embedded in filler prose."""
    rng = random.Random(seed)
    subjects = ["the museum", "the bridge", "the observatory", "the harbor",
                "the festival", "the library", "the cathedral", "the mill"]
    out = []
    for i in range(n_data):
        subj = rng.choice(subjects)
        year = rng.randint(1200, 1990)
        architect = f"{''.join(rng.choice('bcdfgklmnprst') + rng.choice('aeiou') for _ in range(3)).title()}"
        filler1 = synthetic_haystack(900, seed=seed * 1000 + i)
        filler2 = synthetic_haystack(900, seed=seed * 1000 + i + 500)
        ctx = (f"{filler1}\n\n{subj.capitalize()} was designed by {architect} "
               f"and completed in {year}.\n\n{filler2}")
        out.append({
            "context": ctx,
            "question": [f"In what year was {subj} completed?",
                         f"Who designed {subj}?"],
            "answers": [str(year), architect],
        })
    return out


# -------------------------------------------------------------------- needle
def _load_niah(tokenizer, max_len: int = 8000) -> List[dict]:
    out = []
    for context_len in [500, 2000, max_len]:
        gen = NeedleHaystack(tokenizer, context_lengths=[context_len],
                             final_context_length_buffer=0)
        for depth in [i * 10 for i in range(11)]:
            out.append(gen.generate_context_qa(context_len, depth))
    return out


# ----------------------------------------------------------------------- gsm
def _load_gsm(tokenizer, n_data: int, allow_synthetic: bool
              ) -> Tuple[List[dict], bool]:
    try:
        from datasets import load_dataset

        full = load_dataset("openai/gsm8k", "main", split="test")
        out = []
        for data in full:
            st = data["question"].split(". ")
            ctx = ". ".join(st[:-1]).strip() + "."
            if len(tokenizer.encode(ctx, add_special_tokens=False)) < 72:
                continue
            out.append({"context": ctx, "question": [st[-1].strip()],
                        "answers": [data["answer"]]})
            if len(out) == n_data:
                break
        return out, False
    except Exception:
        if not allow_synthetic:
            raise
        return _synthetic_gsm(n_data), True


def _synthetic_gsm(n_data: int) -> List[dict]:
    rng = random.Random(7)
    out = []
    for i in range(n_data):
        a, b, c = rng.randint(3, 20), rng.randint(2, 9), rng.randint(2, 12)
        total = a * b + c
        ctx = (f"A farmer packs apples into crates every morning before the "
               f"market opens. Each of the {a} crates holds exactly {b} "
               f"apples, and the farmer keeps {c} extra apples aside for the "
               f"family. The market is busiest on Saturdays, when all crates "
               f"are sold.")
        out.append({
            "context": ctx,
            "question": ["How many apples does the farmer handle in total?"],
            "answers": [f"#### {total}"],
        })
    return out


# ------------------------------------------------------------------- scbench
def check_scbench_name(name: str):
    tag = name.split("scbench_")[1]
    for suffix in ("_tiny", "_short", "_mid"):
        if tag.endswith(suffix):
            tag = tag[: -len(suffix)]
    assert tag in SCBENCH_TAGS, f"SCBench data name not exist: {name}"


def _load_scbench(name: str, allow_synthetic: bool) -> Tuple[List[dict], bool]:
    check_scbench_name(name)
    try:
        from datasets import load_dataset

        samples = load_dataset("Jang-Hyun/SCBench-preprocessed",
                               data_files=f"{name}.parquet", split="train")
        out = []
        for data in samples:
            gts = []
            for gt in data["ground_truth"]:
                gts.append(", ".join(gt) if isinstance(gt, list) else str(gt))
            out.append({"context": data["prompts"][0],
                        "question": data["prompts"][1:], "answers": gts})
        return out, False
    except Exception:
        if not allow_synthetic:
            raise
        return _synthetic_scbench(name), True


def _synthetic_scbench(name: str) -> List[dict]:
    """Offline stand-in shaped like the matching SCBench task family."""
    rng = random.Random(11)
    size = 8000 if "tiny" in name else 20000
    out = []
    for i in range(8):
        if "_kv" in name:
            pairs = {f"key-{rng.randrange(10**8):08d}":
                     f"value-{rng.randrange(10**10):010d}" for _ in range(60)}
            ctx = "JSON data:\n" + "\n".join(
                f'"{k}": "{v}"' for k, v in pairs.items())
            ctx += "\n\n" + synthetic_haystack(size, seed=100 + i)
            keys = list(pairs)
            qk = rng.choice(keys)
            out.append({"context": ctx,
                        "question": [f'What is the value of key "{qk}"?'],
                        "answers": [pairs[qk]]})
        else:
            out.append({"context": synthetic_haystack(size, seed=200 + i),
                        "question": ["Summarize the previous context."],
                        "answers": ["(no reference)"]})
    return out
