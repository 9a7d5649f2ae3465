"""Generator of the ``serve`` kind: a few long documents compressed at
set-up, then closed-loop batches of ``clients`` queries over them.

Every block of ``clients`` batches holds one batch of each answer length of
an even grid over ``answer_tokens``; every batch holds one query of each
length of an even grid over ``query_tokens``; both orders, and the document
each query asks, are drawn from the seed. Token ids are drawn uniformly
over the vocabulary.
"""

from __future__ import annotations

import numpy as np


class Plan:
    def __init__(self, params: dict, seed: int, vocab: int):
        self.p, self.seed, self.vocab = params, int(seed), vocab
        self.rng = np.random.default_rng([self.seed, 1])
        self.block: list = []

    def _ids(self, rng, n: int) -> np.ndarray:
        return rng.integers(0, self.vocab, size=n, dtype=np.int64)

    def documents(self) -> list:
        rng = np.random.default_rng([self.seed, 3])
        return [self._ids(rng, self.p["doc_length"]) for _ in range(self.p["documents"])]

    def _grid(self, key: str) -> np.ndarray:
        lo, hi = self.p[key]
        return np.rint(np.linspace(lo, hi, self.p["clients"])).astype(int)

    def warmup(self) -> dict:
        """A batch outside the window with the window's query lengths and a
        short answer."""
        rng = np.random.default_rng([self.seed, 2])
        return dict(docs=[i % self.p["documents"] for i in range(self.p["clients"])],
                    queries=[self._ids(rng, n) for n in self._grid("query_tokens")], answer=8)

    def next_batch(self) -> dict:
        """The next batch: the document of each query, the queries' body ids
        and the batch's answer length."""
        if not self.block:
            answers = list(self._grid("answer_tokens"))
            self.rng.shuffle(answers)
            self.block = answers
        qlens = self._grid("query_tokens")
        self.rng.shuffle(qlens)
        docs = self.rng.integers(0, self.p["documents"], size=self.p["clients"])
        return dict(docs=[int(d) for d in docs], queries=[self._ids(self.rng, n) for n in qlens],
                    answer=int(self.block.pop(0)))
