"""Generator of the ``ingest`` kind: documents, one at a time, each
compressed and then asked a few queries.

Lengths come in blocks: every block of ``len(doc_lengths)`` documents holds
each length once, in an order drawn from the seed, so every window sees
nearly the same mix whatever the seed. A block's queries take the lengths
of an even grid over ``query_tokens``, also shuffled. Token ids are drawn
uniformly over the vocabulary.
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

    def warmup(self) -> dict:
        """A document outside the window (its own stream) that takes every
        chunk shape the window's documents take."""
        rng = np.random.default_rng([self.seed, 2])
        lo, hi = self.p["query_tokens"]
        return dict(ctx=self._ids(rng, self.p["warmup_doc"]),
                    queries=[self._ids(rng, hi), self._ids(rng, lo)],
                    answer=self.p["answer_tokens"])

    def next_doc(self) -> dict:
        """The next document of the stream: its ids, its queries' body ids
        and the answer length."""
        if not self.block:
            lens = list(self.p["doc_lengths"])
            n_q = self.p["queries_per_doc"] * len(lens)
            lo, hi = self.p["query_tokens"]
            qlens = np.rint(np.linspace(lo, hi, n_q)).astype(int)
            self.rng.shuffle(lens)
            self.rng.shuffle(qlens)
            k = self.p["queries_per_doc"]
            self.block = [(n, list(qlens[i * k:(i + 1) * k])) for i, n in enumerate(lens)]
        n, qlens = self.block.pop(0)
        return dict(ctx=self._ids(self.rng, n), queries=[self._ids(self.rng, q) for q in qlens],
                    answer=self.p["answer_tokens"])
