"""Deterministic synthetic data: classification pools and LM token streams.

Port of ``repro.data.synthetic`` (``make_classification``,
``GaussianMixture``, ``TokenStream``): identical numpy copies, so the same
seed gives the same data in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GaussianMixture", "TokenStream", "make_classification"]


def make_classification(
    n: int, d: int, n_classes: int, seed: int = 0, spread: float = 5.0
) -> tuple[np.ndarray, np.ndarray]:
    """Clustered classification data (n, d) with integer labels.

    Multi-modal classes (2 clusters per class), zipf-ish class sizes and
    rare secondary modes (15%) — the covtype/Ijcnn1-like regime where
    random subsets miss rare structure but facility-location medoids cover
    it.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, spread, (n_classes * 2, d))
    pc = 1.0 / np.arange(1, n_classes + 1)
    pc /= pc.sum()
    y = rng.choice(n_classes, n, p=pc)
    mode = (rng.random(n) < 0.15).astype(np.int64)
    x = centers[y * 2 + mode] + rng.normal(0, 1.0, (n, d))
    return x.astype(np.float32), y.astype(np.int32)


@dataclasses.dataclass
class GaussianMixture:
    """Index-addressable classification pool (``make_classification``'s
    points and labels, addressed by index)."""

    n: int
    d: int
    n_classes: int
    seed: int = 0

    def __post_init__(self):
        self.x, self.y = make_classification(self.n, self.d, self.n_classes, self.seed)

    def subset(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.x[idx], self.y[idx]

    def class_labels(self, idx: np.ndarray) -> np.ndarray:
        """Per-example class ids: the stratification key of a per-class
        CRAIG refresh (paper §5)."""
        return self.y[np.asarray(idx)]


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic LM corpus of ``n_docs`` sequences.

    Zipf-ish token streams with per-document topics, so gradient proxies
    cluster.  ``example(i)`` regenerates document i from (seed, i): the
    same tokens as the reference's, with no storage and exact restart.
    Each topic's permutation of the vocabulary is kept once computed (it
    depends only on (seed, topic)).
    """

    n_docs: int
    seq_len: int
    vocab_size: int
    n_topics: int = 16
    seed: int = 0
    _perms: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    def _perm(self, topic: int) -> np.ndarray:
        if topic not in self._perms:
            topic_rng = np.random.default_rng((self.seed, 0x7091C, topic))
            self._perms[topic] = topic_rng.permutation(self.vocab_size)
        return self._perms[topic]

    def example(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        perm = self._perm(i % self.n_topics)
        ranks = rng.zipf(1.3, size=self.seq_len + 1) % self.vocab_size
        toks = perm[ranks]
        return toks[:-1].astype(np.int32), toks[1:].astype(np.int32)

    def batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        pairs = [self.example(int(i)) for i in idx]
        return {
            "tokens": np.stack([p[0] for p in pairs]),
            "labels": np.stack([p[1] for p in pairs]),
        }

    def class_labels(self, idx: np.ndarray) -> np.ndarray:
        """Per-document topic ids (the per-class CRAIG key)."""
        return (np.asarray(idx, np.int64) % self.n_topics).astype(np.int32)
