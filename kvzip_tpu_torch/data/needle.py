"""Needle-in-a-haystack (NIAH) retrieval data, generated locally.

Capability parity with reference `data/needle/data.py` (itself adapted from
Long-Context-Data-Engineering): token-level needle insertion at a depth
percentage with sentence-boundary backoff. The haystack here is procedurally
generated essay-like prose (self-contained — no bundled corpus needed), and a
``haystack_dir`` of ``*.txt`` files is supported for parity with the
reference's Paul-Graham-essays layout.
"""

from __future__ import annotations

import glob
import os
import random
from typing import List, Optional

_TOPICS = [
    "the history of shipbuilding", "alpine ecosystems", "the economics of rail",
    "early computing machines", "the chemistry of fermentation",
    "urban planning in coastal cities", "the physiology of long-distance running",
    "medieval manuscript preservation", "the mathematics of tiling",
    "volcanic soil agriculture", "deep-sea cartography", "the sociology of markets",
]

_SENTENCES = [
    "In the early years, progress on {t} was slow and often misunderstood.",
    "Scholars who studied {t} kept meticulous notes that survive to this day.",
    "A common misconception about {t} is that it developed in isolation.",
    "The practical implications of {t} reached far beyond their origins.",
    "Several competing schools of thought shaped how {t} was taught.",
    "Careful measurement transformed {t} from folklore into a discipline.",
    "Regional differences in {t} produced a surprising diversity of methods.",
    "By the turn of the century, {t} had attracted serious investment.",
    "Critics argued that {t} ignored important social consequences.",
    "Modern reappraisals of {t} emphasize continuity rather than revolution.",
    "Archives reveal that practitioners of {t} borrowed freely from neighbors.",
    "The tools used in {t} evolved gradually, each generation refining the last.",
]

DEFAULT_NEEDLE = ("\nThe best thing to do in San Francisco is eat a sandwich "
                  "and sit in Dolores Park on a sunny day.\n")
DEFAULT_QUESTION = ("Based on the content of the book, the best thing to do in "
                    "San Francisco is: ")
DEFAULT_ANSWER = "Eat a sandwich and sit in Dolores Park on a sunny day."


def synthetic_haystack(min_chars: int, seed: int = 0) -> str:
    rng = random.Random(seed)
    parts: List[str] = []
    size = 0
    while size < min_chars:
        topic = rng.choice(_TOPICS)
        para = " ".join(rng.choice(_SENTENCES).format(t=topic)
                        for _ in range(rng.randint(4, 9)))
        parts.append(para)
        size += len(para) + 2
    return "\n\n".join(parts)


class NeedleHaystack:
    """Generate needle-retrieval contexts at (length, depth) grid points."""

    def __init__(self, tokenizer, context_lengths=(8000,),
                 haystack_dir: Optional[str] = None,
                 needle: str = DEFAULT_NEEDLE,
                 retrieval_question: str = DEFAULT_QUESTION,
                 answer: str = DEFAULT_ANSWER,
                 final_context_length_buffer: int = 0):
        self.tok = tokenizer
        self.context_lengths = list(context_lengths)
        self.haystack_dir = haystack_dir
        self.needle = needle
        self.question = retrieval_question
        self.answer = answer
        self.buffer = final_context_length_buffer

    def _encode(self, text: str) -> List[int]:
        return list(self.tok.encode(text, add_special_tokens=False))

    def _haystack_text(self, max_tokens: int) -> str:
        if self.haystack_dir and os.path.isdir(self.haystack_dir):
            files = sorted(glob.glob(os.path.join(self.haystack_dir, "*.txt")))
            text = ""
            while len(self._encode(text)) < max_tokens and files:
                for f in files:
                    with open(f) as fh:
                        text += fh.read()
                    if len(self._encode(text)) >= max_tokens:
                        break
            return text
        # ~4 chars/token is a safe overestimate for prose
        return synthetic_haystack(max_tokens * 6)

    def generate_context(self, context_length: int, depth_percent: float) -> str:
        target = context_length - self.buffer
        ctx_tokens = self._encode(self._haystack_text(context_length))
        needle_tokens = self._encode(self.needle)
        if len(ctx_tokens) + len(needle_tokens) > target:
            ctx_tokens = ctx_tokens[:target - len(needle_tokens)]

        if depth_percent >= 100:
            merged = ctx_tokens + needle_tokens
        else:
            point = int(len(ctx_tokens) * depth_percent / 100)
            period_tokens = set(self._encode(".") + self._encode(".\n"))
            # back off to a sentence boundary (reference data.py:85-93)
            while point > 0 and ctx_tokens[point - 1] not in period_tokens:
                point -= 1
            merged = ctx_tokens[:point] + needle_tokens + ctx_tokens[point:]
        return self.tok.decode(merged)

    def generate_context_qa(self, context_length: int, depth_percent: float):
        ctx = self.generate_context(context_length, depth_percent)
        return {"context": ctx.strip(), "question": [self.question],
                "answers": [self.answer]}
