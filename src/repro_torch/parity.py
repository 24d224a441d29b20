"""Greedy index parity under the tie rule (no counterpart in ``repro``).

Two fp32 implementations of the same greedy can legitimately pick
different winners when the top two gains are closer than fp32 rounding
of the distances: the self-distance from ‖x‖² + ‖x‖² − 2·x·x comes out
at about √ε₃₂·‖x‖ instead of 0, differently in every dot order.  The rule
the tests and ``chip_smoke.py`` hold both packages to:

  * indices must agree up to the first divergence;
  * at a divergence, the two picks' gains given the common prefix,
    recomputed in fp64, must both lie within ``tol`` of the fp64 best;
  * past it the runs are compared by objective value, not by index.

Stochastic greedy is held to the same rule with its step samples: each
pick is the best of its own step's candidates, so the best is taken over
that sample.  A weighted greedy (the merge rounds of distributed
selection, each candidate standing for γ points) is held to it with its
point weights, and a tolerance scaled by the largest weight.
"""
from __future__ import annotations

import torch

__all__ = ["tie_tolerance", "fp64_gains", "coverage64", "first_divergence"]


def tie_tolerance(x: torch.Tensor) -> float:
    """τ = 8·√ε₃₂·max‖x‖: a few rows' worth of self-distance rounding."""
    eps = torch.finfo(torch.float32).eps
    return 8.0 * eps**0.5 * float(torch.linalg.norm(x.double(), dim=1).max())


def _dist64(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return torch.cdist(x, x)


def fp64_gains(x: torch.Tensor, prefix, weights=None) -> torch.Tensor:
    """(n,) fp64 marginal gains given the selected ``prefix``; chosen → −inf.

    gain(e) = Σ_i w_i·relu(min_{s∈prefix} D_is − D_ie) (w_i = 1 without
    ``weights``), with D_is := +max D for an empty prefix (the d_max
    offset cancels).
    """
    dist = _dist64(x)
    prefix = torch.as_tensor(prefix, dtype=torch.int64, device=dist.device)
    if prefix.numel():
        cover = dist[:, prefix].min(dim=1).values
    else:
        cover = torch.full_like(dist[:, 0], float(dist.max()) + 1e-6)
    gap = torch.clamp(cover[:, None] - dist, min=0.0)
    if weights is not None:
        gap = gap * torch.as_tensor(weights, dtype=torch.float64, device=gap.device)[:, None]
    g = gap.sum(dim=0)
    g[prefix] = float("-inf")
    return g


def coverage64(x: torch.Tensor, indices) -> float:
    """L(S) = Σ_i min_{j∈S} ‖x_i − x_j‖ in fp64."""
    idx = torch.as_tensor(indices, dtype=torch.int64, device=x.device)
    return float(_dist64(x)[:, idx].min(dim=1).values.sum())


def first_divergence(x: torch.Tensor, idx_a, idx_b, tol: float, candidates=None,
                     weights=None):
    """Position of the first index divergence, or None when equal.

    Raises AssertionError when the two picks at the divergence are not a
    near-tie (either is more than ``tol`` below the fp64 best gain).
    ``candidates`` (stochastic greedy): row t is the sample drawn for
    position t, and the best gain is taken over it.  ``weights``: the
    point weights of a weighted greedy.
    """
    a = [int(i) for i in idx_a]
    b = [int(i) for i in idx_b]
    if len(a) != len(b):
        raise AssertionError(f"selection sizes differ: {len(a)} vs {len(b)}")
    t = next((k for k in range(len(a)) if a[k] != b[k]), None)
    if t is None:
        return None
    g = fp64_gains(x, a[:t], weights)
    pool = g if candidates is None else g[
        torch.as_tensor(candidates[t], dtype=torch.int64, device=g.device)]
    best = float(pool.max())
    ga, gb = float(g[a[t]]), float(g[b[t]])
    if best - ga > tol or best - gb > tol:
        raise AssertionError(
            f"greedy divergence at position {t} is not a near-tie: picks "
            f"{a[t]} (fp64 gain {ga!r}) and {b[t]} ({gb!r}), best {best!r}, "
            f"tolerance {tol!r}"
        )
    return t
