"""Host-side lazy greedy engine (Minoux 1978).

Port of ``repro.core.engines.lazy``: exact greedy with a max-heap of stale
upper bounds; submodularity guarantees that a popped entry whose bound was
recomputed this round is the true argmax, so most candidates are never
re-evaluated.  The heap runs on the host in float64, as the reference's,
over d_max − dist, where dist is the fp32 ``pairwise_distances`` of the
features computed on their device and then cast (fp64 distances would
move ties away from the reference's).  Selections are the matrix
engine's.

The float64 matrix crosses to the host column-major, so that the column
of a candidate the heap re-evaluates is contiguous; the values, and every
sum over them, are the reference's.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import ClassVar

import numpy as np
import torch

from repro_torch.core.engines.base import (
    Capabilities,
    EngineConfig,
    FLResult,
    SelectionEngine,
    coverage_l,
    pairwise_distances,
)
from repro_torch.core.engines.registry import register_engine

__all__ = ["LazyConfig", "LazyEngine", "lazy_greedy_fl"]


def _host_f64(sim) -> np.ndarray:
    """(n, n) similarities → a float64 host array; a tensor comes over in
    column-major order (``sim[:, e]`` contiguous)."""
    if isinstance(sim, torch.Tensor):
        return sim.T.contiguous().double().cpu().numpy().T
    return np.asarray(sim, np.float64)


def lazy_greedy_fl(sim, budget: int, init_selected=None) -> FLResult:
    """Exact lazy greedy with a max-heap of stale upper bounds.

    Selections equal ``greedy_fl_matrix``'s (ties to the lowest index) with
    far fewer gain evaluations.  ``init_selected`` warm-starts: the prefix
    is installed first (gains replayed in order) and the heap is built
    against the warmed cover state.

    Args:
      sim: (n, n) similarities, a numpy array or a tensor on any device.
      budget: r; clamped to n.
      init_selected: optional (r₀ ≤ r,) warm-start prefix.

    Returns an ``FLResult`` of CPU tensors.
    """
    sim = _host_f64(sim)
    n = sim.shape[0]
    budget = min(budget, n)
    cur_max = np.zeros(n)
    indices, gains = [], []
    if init_selected is not None:
        init = np.asarray(init_selected, np.int64)
        if init.shape[0] > budget:
            raise ValueError(
                f"init_selected has {init.shape[0]} elements > budget {budget}"
            )
        for e in init:
            e = int(e)
            indices.append(e)
            gains.append(float(np.maximum(sim[:, e] - cur_max, 0.0).sum()))
            cur_max = np.maximum(cur_max, sim[:, e])
    r0 = len(indices)
    in_init = set(indices)
    # heap of (-gain, index, stamp); stamp = |S| when the gain was computed
    heap = [
        (-float(np.maximum(sim[:, e] - cur_max, 0.0).sum()), e, r0)
        for e in range(n)
        if e not in in_init
    ]
    heapq.heapify(heap)
    for t in range(r0, budget):
        while True:
            neg_g, e, stamp = heapq.heappop(heap)
            if stamp == t:
                break
            g = float(np.maximum(sim[:, e] - cur_max, 0.0).sum())
            heapq.heappush(heap, (-g, e, t))
        indices.append(e)
        gains.append(-neg_g)
        cur_max = np.maximum(cur_max, sim[:, e])
    idx = np.array(indices, np.int64)
    assign = np.argmax(sim[:, idx], axis=1)
    weights = np.bincount(assign, minlength=budget).astype(np.float32)
    coverage = float(np.sum(sim.max(axis=1) - cur_max))
    return FLResult(
        torch.from_numpy(idx),
        torch.tensor(gains, dtype=torch.float32),
        torch.from_numpy(weights),
        torch.tensor(coverage, dtype=torch.float32),
    )


@dataclasses.dataclass(frozen=True)
class LazyConfig(EngineConfig):
    """Host lazy greedy — no knobs (the heap is self-tuning)."""

    name: ClassVar[str] = "lazy"


@register_engine
class LazyEngine(SelectionEngine):
    name = "lazy"
    config_cls = LazyConfig
    capabilities = Capabilities(
        exact=True,
        matrix_free=False,
        device_resident=False,  # host heapq loop
        supports_cover=False,
        supports_metrics=("l2", "cosine"),
        memory=lambda n, d: 8 * n * n,  # float64 similarity on the host
    )

    def select(
        self, feats, budget, *, metric="l2", init_selected=None, rng=None
    ) -> FLResult:
        dist = pairwise_distances(feats, metric)
        d_max = torch.max(dist) + 1e-6
        res = lazy_greedy_fl(d_max - dist, budget, init_selected=init_selected)
        dev = dist.device
        idx = res.indices.to(dev)
        return FLResult(idx, res.gains.to(dev), res.weights.to(dev), coverage_l(dist, idx))
