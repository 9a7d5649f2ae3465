"""Tokenizer access: HuggingFace when available, byte-level fallback offline.

The reference relies on ``AutoTokenizer`` (`model/load.py:64`); we do the same
when tokenizer files are reachable, and otherwise fall back to a deterministic
byte tokenizer so the full pipeline (prefill/scoring/prune/decode/eval) runs
hermetically in tests and air-gapped benchmarks.
"""

from __future__ import annotations

from typing import List

import numpy as np


class ByteTokenizer:
    """Deterministic offline tokenizer: UTF-8 bytes + special tokens.

    ids 0..255 = bytes; 256.. = specials. Vocab is padded to ``vocab_size``.
    """

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self._specials = {"<bos>": 256, "<eos>": 257, "<pad>": 258}
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}


def load_tokenizer(model_id: str, vocab_size: int = 512):
    """Try HF AutoTokenizer (local path or cache only; no network); else
    fall back to the deterministic ByteTokenizer."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(
            model_id, trust_remote_code=True, local_files_only=True)
    except Exception:
        return ByteTokenizer(vocab_size=vocab_size)
