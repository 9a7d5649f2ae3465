"""The token ids both sides are given, and the KVzip prompts the reference
works out again: a frozen copy of the qwen chat template and of KVzip's
reconstruction prompts, tokenized as UTF-8 bytes (the byte tokenizer the
benchmark hands the program: ids 0-255 are bytes).

The program adds its own system prompt in front of a document (the sink)
and builds its own repeat prompts; the reference builds them again from
these strings, so a change to either on the program's side shows as a gap.
"""

from __future__ import annotations

import numpy as np

# KVzip's scoring: the context in chunks of this many tokens, each repeated
# after a prompt that ends with the last PREV_TAIL ids of the chunk before
SCORE_CHUNK = 2000
PREV_TAIL = 8

_QA = "Given the context, answer to the following question or request without explanation.\n\n"


def _ids(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int64)


def template(family: str) -> tuple:
    """(system prompt ids, assistant postfix ids) of the qwen2/qwen3 chat
    template with the question-answering instruction."""
    if family not in ("qwen2", "qwen3"):
        raise ValueError(f"no template for family {family!r}")
    prefix = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n" + _QA
    postfix = "<|im_end|>\n<|im_start|>assistant\n"
    if family == "qwen3":
        postfix += "<think>\n\n</think>\n\n"
    return _ids(prefix), _ids(postfix)


def query_ids(family: str, body: np.ndarray) -> np.ndarray:
    """A query as the program receives it: a blank line, the body's ids,
    then the assistant postfix."""
    _, postfix = template(family)
    return np.concatenate([_ids("\n\n"), np.asarray(body, np.int64), postfix])


def repeat_prompts(family: str, ctx: np.ndarray) -> list:
    """KVzip's reconstruction task over the context: for each chunk, (start
    in the context, chunk length, ids of prompt + postfix + chunk)."""
    _, postfix = template(family)
    out = []
    for i, start in enumerate(range(0, len(ctx), SCORE_CHUNK)):
        chunk = ctx[start:start + SCORE_CHUNK]
        if i == 0:
            q = _ids("\n\nRepeat the previous context exactly.")
        else:
            q = np.concatenate([_ids("\n\nRepeat the part of the previous context exactly, "
                                     "starting with "), ctx[start - PREV_TAIL:start]])
        out.append((start, len(chunk), np.concatenate([q, postfix, chunk]).astype(np.int64)))
    return out
