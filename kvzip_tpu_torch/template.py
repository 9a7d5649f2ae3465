"""Chat templates per model family (parity: reference `model/template.py`)."""

from __future__ import annotations


def template(model_name: str, task: str = "qa"):
    name = model_name.lower()

    if "llama" in name or name == "duo":
        prefix = "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
        prefix += ("You are a helpful assistant<|eot_id|>"
                   "<|start_header_id|>user<|end_header_id|>\n\n")
        postfix = "\n\n<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n"
    elif name.startswith("qwen"):
        prefix = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        prefix += "<|im_start|>user\n"
        postfix = "<|im_end|>\n<|im_start|>assistant\n"
        if "qwen3-" in name:
            postfix += "<think>\n\n</think>\n\n"
    elif name.startswith("gemma3") or name.startswith("gemma-3"):
        prefix = "<bos><start_of_turn>user\n"
        prefix += "You are a helpful assistant.\n\n"
        postfix = "<end_of_turn>\n<start_of_turn>model\n"
    elif name.startswith("tiny"):
        prefix = "<sys>assistant</sys>\n"
        postfix = "\n<answer>"
    else:
        prefix = "<|begin_of_text|>"
        postfix = "\n\nAnswer: "

    if task.startswith("gsm"):
        prefix += "Given the context, answer to the following reasoning question.\n\n"
    else:
        prefix += ("Given the context, answer to the following question or "
                   "request without explanation.\n\n")
    return prefix, postfix


# eos ids per family, used by the greedy decode loop (reference gen_kwargs,
# model/wrapper.py:81-95)
def eos_ids(model_name: str, tokenizer) -> list:
    name = model_name.lower()
    ids = []
    if getattr(tokenizer, "eos_token_id", None) is not None:
        eid = tokenizer.eos_token_id
        ids += list(eid) if isinstance(eid, (list, tuple)) else [eid]
    if name.startswith("gemma3"):
        ids += [1, 106]
    elif "qwen3-" in name:
        ids += [151645]
    elif "qwen" in name:
        ids += [151645]
    elif "llama" in name:
        ids += [128001, 128009]
    return sorted(set(int(i) for i in ids))
