"""Matrix-free blocked greedy engine from features.

Port of ``repro.core.engines.features``.  Per greedy step, every
candidate's gain is computed from the features — O(n²·d) per step,
O(n·block) memory; the (n, n) similarity never exists.  ``gains_impl``
picks the sweep: ``'cuda'`` launches the hand-written ``fl_gains`` kernel
once over all candidates, ``'torch'`` runs its plain twin block by block,
``'auto'`` takes the kernel on a card and the twin on the CPU.  The
reference's unused ``sim_fn='dot'`` variant is not ported.
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
    _replay_prefix,
    cosine_residual_coverage,
    normalize_for_metric,
)
from repro_torch.core.engines.registry import register_engine
from repro_torch.kernels import ops as kops

__all__ = ["FeaturesConfig", "FeaturesEngine", "greedy_fl_features"]


def greedy_fl_features(
    feats: torch.Tensor,
    budget: int,
    *,
    gains_impl: str = "auto",
    block_n: int = 512,
    init_selected=None,
) -> FLResult:
    """Greedy FL directly from proxy features, never materializing (n, n).

    s_ij = d_max − ‖x_i − x_j‖ (the paper's metric), d_max = 2·max‖x‖.

    Args:
      feats: (n, d) proxy features.
      budget: r.
      gains_impl: 'auto' (the kernel on a card, the plain sweep on the
        CPU) | 'cuda' | 'torch' (the reference's 'pallas' | 'jax').
      block_n: candidate block of the plain sweep.
      init_selected: optional warm-start prefix.
    """
    n, _ = feats.shape
    dev = feats.device
    feats = feats.float()
    budget = int(min(budget, n))
    sq = torch.sum(feats * feats, dim=-1)
    # d_max upper bound: max pairwise distance ≤ 2·max‖x‖ (triangle ineq.)
    d_max = 2.0 * torch.sqrt(torch.max(sq)) + 1e-6
    impl = kops.resolve_impl(gains_impl, dev)

    def sim_block(cand_idx: torch.Tensor) -> torch.Tensor:
        """(n, m) similarity of every point to the candidate block."""
        cf = feats[cand_idx]
        d2 = sq[:, None] + sq[cand_idx][None, :] - 2.0 * (feats @ cf.T)
        return d_max - torch.sqrt(torch.clamp(d2, min=0.0))

    init_idx, init_gains, cur_max, chosen = _replay_prefix(
        init_selected, budget, n, lambda e: sim_block(e.view(1))[:, 0],
        device=dev,
    )
    steps = budget - init_idx.shape[0]
    new_idx = torch.empty((steps,), dtype=torch.int64, device=dev)
    new_gains = torch.empty((steps,), dtype=torch.float32, device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    for t in range(steps):
        # the winner stays a (1,) device tensor: no host sync per round
        g = kops.fl_gains(
            feats, feats, cur_max, sq, sq, d_max, gains_impl=impl, block_m=block_n
        )
        g = torch.where(chosen, neg, g)
        e = torch.argmax(g).view(1)
        cur_max = torch.maximum(cur_max, sim_block(e)[:, 0])
        chosen.index_fill_(0, e, True)
        new_idx[t:t + 1] = e
        new_gains[t:t + 1] = g.index_select(0, e)
    indices = torch.cat([init_idx, new_idx])
    gains = torch.cat([init_gains, new_gains])

    # Weights: assign every i to its most-similar selected element.
    sel_sim = sim_block(indices)  # (n, r)
    assign = torch.argmax(sel_sim, dim=1)  # first maximum, as jnp.argmax
    weights = torch.bincount(assign, minlength=budget).to(torch.float32)
    # L(S) = Σ_i min_{j∈S} ‖x_i − x_j‖
    coverage = torch.sum(d_max - torch.max(sel_sim, dim=1).values)
    return FLResult(indices, gains, weights, coverage)


@dataclasses.dataclass(frozen=True)
class FeaturesConfig(EngineConfig):
    """Matrix-free blocked greedy.

    Attributes:
      gains_impl: 'auto' (kernel on a card, plain sweep on the CPU) |
        'cuda' (the ``fl_gains`` kernel) | 'torch' (plain sweep).
      block_n: candidate block of the plain sweep (the kernel picks its own).
    """

    name: ClassVar[str] = "features"
    gains_impl: str = "auto"
    block_n: int = 512


@register_engine
class FeaturesEngine(SelectionEngine):
    name = "features"
    config_cls = FeaturesConfig
    capabilities = Capabilities(
        exact=True,
        matrix_free=True,
        device_resident=True,
        supports_cover=False,
        supports_metrics=("l2", "cosine"),  # cosine via normalized l2
        memory=lambda n, d: 4 * n * (d + 512),
    )

    def select(
        self, feats, budget, *, metric="l2", init_selected=None, rng=None
    ) -> FLResult:
        feats = normalize_for_metric(feats, metric)
        res = greedy_fl_features(
            feats,
            budget,
            gains_impl=self.config.gains_impl,
            block_n=self.config.block_n,
            init_selected=init_selected,
        )
        if metric == "cosine":  # report L(S) in cosine-distance units
            res = res._replace(
                coverage=cosine_residual_coverage(feats, res.indices)
            )
        return res
