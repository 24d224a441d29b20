"""The seeded token corpus: a frozen copy of the port's ``TokenStream``.

Zipf-ish token streams with a topic per document (``repro_torch``'s
``data/synthetic.py::TokenStream``, copied so that a change there cannot
move the benchmark's inputs).  Every document is made once, in set-up,
into one (n_docs, seq_len + 1) array; ``batch`` only indexes it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Corpus", "derive_seed"]


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (any whole number)."""
    entropy = [abs(int(seed)) % (1 << 64), int(seed < 0)]
    for t in tags:
        entropy.append(t if isinstance(t, int) else int.from_bytes(str(t).encode(), "little")
                       % (1 << 64))
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class Corpus:
    """``n_docs`` documents of ``seq_len`` tokens (inputs) and their next
    tokens (labels), as ``TokenStream(n_docs, seq_len, vocab_size,
    n_topics, seed)`` makes them.

    ``batch(idx)`` is what the trainer and the extractor call."""

    def __init__(self, n_docs: int, seq_len: int, vocab_size: int, n_topics: int, seed: int):
        self.n_docs, self.seq_len, self.vocab_size = int(n_docs), int(seq_len), int(vocab_size)
        self.n_topics, self.seed = int(n_topics), int(seed)
        perms = {}
        rows = np.empty((self.n_docs, self.seq_len + 1), np.int32)
        for i in range(self.n_docs):
            topic = i % self.n_topics
            if topic not in perms:
                perms[topic] = np.random.default_rng((self.seed, 0x7091C, topic)).permutation(
                    self.vocab_size)
            rng = np.random.default_rng((self.seed, i))
            ranks = rng.zipf(1.3, size=self.seq_len + 1) % self.vocab_size
            rows[i] = perms[topic][ranks]
        self.rows = rows

    def tokens(self, idx) -> np.ndarray:
        return self.rows[np.asarray(idx, np.int64), :-1]

    def labels(self, idx) -> np.ndarray:
        return self.rows[np.asarray(idx, np.int64), 1:]

    def batch(self, idx) -> dict:
        return {"tokens": self.tokens(idx), "labels": self.labels(idx)}
