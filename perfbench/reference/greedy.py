"""CRAIG's selection in fp64 (paper Alg. 1): greedy facility location over
d_ij = ‖x_i − x_j‖, with an auxiliary element at distance max d + 1e-6
from every point, and γ_j = the points nearest to medoid j."""
from __future__ import annotations

import torch

__all__ = ["distances", "greedy", "coverage", "cluster_sizes"]


def distances(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")


def greedy(dist: torch.Tensor, budget: int, init: list[int]) -> list[int]:
    """Medoids in greedy order: ``init`` first, then the point with the
    largest drop of Σ_i min_{j∈S} d_ij each round (first one on a tie)."""
    n = dist.shape[0]
    cur = torch.full((n,), float(dist.max()) + 1e-6, dtype=dist.dtype, device=dist.device)
    chosen = []
    for e in init:
        cur = torch.minimum(cur, dist[:, e])
        chosen.append(int(e))
    taken = torch.zeros(n, dtype=torch.bool, device=dist.device)
    taken[chosen] = True
    while len(chosen) < budget:
        gains = torch.clamp(cur[:, None] - dist, min=0.0).sum(dim=0)
        gains[taken] = -1.0
        e = int(torch.argmax(gains))
        cur = torch.minimum(cur, dist[:, e])
        taken[e] = True
        chosen.append(e)
    return chosen


def coverage(dist: torch.Tensor, medoids: list[int]) -> float:
    """L(S) = Σ_i min_{j∈S} d_ij (paper Eq. 8)."""
    return float(dist[:, medoids].min(dim=1).values.sum())


def cluster_sizes(dist: torch.Tensor, medoids: list[int]) -> torch.Tensor:
    """γ in the order of ``medoids``: each point counts for its nearest
    medoid, the earlier one on a tie."""
    near = torch.argmin(dist[:, medoids], dim=1)
    return torch.bincount(near, minlength=len(medoids)).double()
