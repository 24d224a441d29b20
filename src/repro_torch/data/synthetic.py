"""Deterministic synthetic classification pools.

Port of ``repro.data.synthetic.make_classification``: an identical numpy
copy, so the same seed gives the same data in both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_classification"]


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
