"""Dense exact greedy engine — and the only cover engine.

Port of ``repro.core.engines.matrix``.  ``greedy_fl_matrix`` maximizes F
over a precomputed (n, n) similarity matrix, O(r·n²); the reference's
``lax.scan`` becomes a Python loop whose winner stays a device tensor (no
host round trip per round).  The dense distances are a plain
``torch.matmul`` (``base.pairwise_distances``), as the reference leaves
them to jnp.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.core.engines.base import (
    Capabilities,
    EngineConfig,
    FLResult,
    SelectionEngine,
    _cluster_weights,
    _replay_prefix,
    assign_and_weights,
    coverage_l,
    pairwise_distances,
)
from repro_torch.core.engines.registry import register_engine

__all__ = ["MatrixConfig", "MatrixEngine", "greedy_fl_matrix"]


def greedy_fl_matrix(
    sim: torch.Tensor,
    budget: int,
    point_weights: torch.Tensor | None = None,
    init_selected=None,
) -> FLResult:
    """Exact greedy maximization of F over a dense (n, n) similarity matrix.

    Maintains cur_max_i = max_{j∈S} s_ij (0 for the auxiliary element); the
    marginal gain of candidate e is Σ_i w_i·relu(s_ie − cur_max_i).

    Args:
      sim: (n, n) similarities, s_ij ≥ 0; sim[i, e] = benefit of e for i.
      budget: r, number of elements to select.
      point_weights: optional (n,) per-point multiplicities (default 1).
      init_selected: optional (r₀ ≤ r,) warm-start prefix, installed first.
    """
    n = sim.shape[0]
    dev = sim.device
    sim = sim.float()
    pw = (
        torch.ones((n,), dtype=torch.float32, device=dev)
        if point_weights is None
        else point_weights.float()
    )
    init_idx, init_gains, cur_max, chosen = _replay_prefix(
        init_selected, budget, n, lambda e: sim[:, e.view(1)][:, 0], pw=pw,
        device=dev,
    )
    steps = budget - init_idx.shape[0]
    new_idx = torch.empty((steps,), dtype=torch.int64, device=dev)
    new_gains = torch.empty((steps,), dtype=torch.float32, device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    for t in range(steps):
        # the winner stays a (1,) device tensor: no host sync per round
        gains = pw @ torch.clamp(sim - cur_max[:, None], min=0.0)
        gains = torch.where(chosen, neg, gains)
        e = torch.argmax(gains).view(1)  # first maximum, as jnp.argmax
        cur_max = torch.maximum(cur_max, sim.index_select(1, e)[:, 0])
        chosen.index_fill_(0, e, True)
        new_idx[t:t + 1] = e
        new_gains[t:t + 1] = gains.index_select(0, e)
    indices = torch.cat([init_idx, new_idx])
    gains = torch.cat([init_gains, new_gains])
    weights = _cluster_weights(sim, indices, point_weights)
    # residual un-covered similarity mass, as the reference reports it;
    # MatrixEngine replaces it with L(S) from the distances
    coverage = torch.sum(torch.max(sim, dim=1).values - cur_max)
    return FLResult(indices, gains, weights, coverage)


@dataclasses.dataclass(frozen=True)
class MatrixConfig(EngineConfig):
    """Dense exact greedy — no knobs; the whole surface is the metric."""

    name: ClassVar[str] = "matrix"


@register_engine
class MatrixEngine(SelectionEngine):
    name = "matrix"
    config_cls = MatrixConfig
    capabilities = Capabilities(
        exact=True,
        matrix_free=False,
        device_resident=True,
        supports_cover=True,
        supports_metrics=("l2", "cosine"),
        memory=lambda n, d: 8 * n * n,  # dist + sim, fp32 each
    )

    def select(
        self, feats, budget, *, metric="l2", init_selected=None, rng=None
    ) -> FLResult:
        dist = pairwise_distances(feats, metric)
        d_max = torch.max(dist) + 1e-6
        res = greedy_fl_matrix(d_max - dist, budget, init_selected=init_selected)
        return res._replace(coverage=coverage_l(dist, res.indices))

    def select_cover(self, feats, epsilon, *, metric="l2") -> FLResult:
        """Submodular cover (paper Eq. 12): grow until L(S) ≤ epsilon.

        Runs greedy with the full budget, then cuts at the first prefix
        whose coverage meets ε; ε unreachable keeps everything.
        """
        dist = pairwise_distances(feats, metric)
        d_max = torch.max(dist) + 1e-6
        n = dist.shape[0]
        res = greedy_fl_matrix(d_max - dist, n)
        run_min = torch.cummin(dist[:, res.indices], dim=1).values
        cov_prefix = torch.sum(run_min, dim=0)  # L(S_k) for k = 1..n
        met = (cov_prefix <= epsilon).cpu()
        k = int(torch.argmax(met.to(torch.int8))) + 1 if bool(met.any()) else n
        idx = res.indices[:k]
        _, w = assign_and_weights(dist[:, idx])
        return FLResult(idx, res.gains[:k], w, cov_prefix[k - 1])
