"""Result persistence + per-dataset generation-length policy
(reference `utils/func.py:7-30`). Layout:
``results/{data}/{idx}_{model}{tag}/output-{level}.json`` — per-sample files
so interrupted ratio sweeps resume at sample granularity."""

from __future__ import annotations

import json
import os


def set_gen_length(dataname: str, engine=None) -> int:
    if dataname in ("needle",) or "_mf" in dataname:
        max_len = 32
    elif dataname in ("squad",) or "summary" in dataname:
        max_len = 256
    elif "gsm" in dataname or "repoqa" in dataname:
        max_len = 512
    else:
        max_len = 96
    if engine is not None:
        engine.max_new_tokens = max_len
    print(f"set generation length: {max_len}")
    return max_len


def save_result(outputs, dataname: str, idx: int, model: str,
                level: str = "pair", tag: str = "", root: str = "./results"):
    folder_tag = f"_{tag}" if tag else ""
    path = os.path.join(root, dataname, f"{idx}_{model}{folder_tag}")
    os.makedirs(path, exist_ok=True)
    out_file = os.path.join(path, f"output-{level}.json")
    with open(out_file, "w") as f:
        json.dump(outputs, f, indent=4)
    return out_file
