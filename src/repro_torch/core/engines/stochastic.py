"""Stochastic greedy engine (Mirzasoleiman et al. 2015a).

Port of ``repro.core.engines.stochastic``: the paper's O(|V|) fast path
(§3.2, §3.4).  Each step evaluates gains on a random candidate sample of
size (n/r)·ln(1/δ), a (1−1/e−δ) approximation in expectation.

JAX's threefry keys have no PyTorch counterpart, so the random stream is
the port's own: every step's candidates are drawn up front by
:func:`draw_candidates` from a CPU ``torch.Generator`` and then moved to
the similarities' device, so a run on the card and a run on the CPU sample
the same candidates.  The greedy loop keeps its state on the device
(``torch.where``/``torch.argmax``, no host sync per step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from repro_torch.core.engines.base import (
    Capabilities,
    EngineConfig,
    FLResult,
    SelectionEngine,
    _cluster_weights,
    _replay_prefix,
    coverage_l,
    pairwise_distances,
)
from repro_torch.core.engines.registry import register_engine

__all__ = ["StochasticConfig", "StochasticEngine", "draw_candidates", "sample_size",
           "stochastic_greedy_fl"]


def _cpu_generator(key) -> torch.Generator:
    if key is None:
        key = 0
    if isinstance(key, torch.Generator):
        if key.device.type != "cpu":
            raise ValueError(
                f"stochastic greedy draws its candidates on the CPU; got a "
                f"{key.device.type} generator"
            )
        return key
    return torch.Generator().manual_seed(int(key))


def draw_candidates(key, steps: int, n: int, sample_size: int) -> torch.Tensor:
    """Every step's candidates, drawn at once: a (steps, sample_size) int64
    CPU tensor of indices in [0, n), with replacement.

    Args:
      key: an int seed (None → 0) or a CPU ``torch.Generator``.
    """
    return torch.randint(0, n, (steps, sample_size), generator=_cpu_generator(key),
                         dtype=torch.int64)


def stochastic_greedy_fl(
    sim: torch.Tensor,
    budget: int,
    key,
    sample_size: int,
    init_selected=None,
) -> FLResult:
    """Stochastic greedy: each step evaluates gains on a random candidate set.

    With sample_size = (n/r)·log(1/δ) the result is a (1−1/e−δ)
    approximation in expectation (Mirzasoleiman et al., AAAI'15), with
    O(n·log 1/δ) total gain evaluations.

    When every sampled candidate is already selected, the step falls back
    to the first unchosen element instead of re-selecting a masked
    candidate — selections are always unique.  ``sample_size >= n`` is the
    δ→0 limit: the step sweeps every candidate and the engine is exact
    greedy.

    Args:
      sim: (n, n) similarities; gathered by column, so a column-major
        tensor (``sim.T`` contiguous) is read without a copy.
      budget: r; clamped to n.
      key: an int seed or a CPU ``torch.Generator`` (:func:`draw_candidates`).
      sample_size: candidates per step.
      init_selected: optional warm-start prefix (see ``greedy_fl_matrix``).
    """
    n = sim.shape[0]
    dev = sim.device
    budget = int(min(budget, n))
    cols = sim.float().T.contiguous()  # cols[e] = sim[:, e]
    init_idx, init_gains, cur_max, chosen = _replay_prefix(
        init_selected, budget, n, lambda e: cols[e], device=dev
    )
    steps = budget - init_idx.shape[0]
    full_sweep = sample_size >= n  # δ→0: evaluate everything, exact greedy
    if not full_sweep:
        cands = draw_candidates(key, steps, n, sample_size).to(dev)
    new_idx = torch.empty((steps,), dtype=torch.int64, device=dev)
    new_gains = torch.empty((steps,), dtype=torch.float32, device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    for t in range(steps):
        # every winner stays a (1,) device tensor: no host sync per step
        cand = None if full_sweep else cands[t]
        cand_cols = cols if full_sweep else cols.index_select(0, cand)  # (m, n)
        gains = torch.sum(torch.clamp(cand_cols - cur_max[None, :], min=0.0), dim=1)
        gains = torch.where(chosen if full_sweep else chosen[cand], neg, gains)
        best = torch.argmax(gains).view(1)  # first maximum, as jnp.argmax
        g_best = gains.index_select(0, best)
        # every candidate already chosen: take the first unchosen element
        # (one always exists while |S| < n)
        all_dup = ~torch.isfinite(g_best)
        fallback = torch.argmax((~chosen).to(torch.uint8)).view(1)
        g_fallback = torch.sum(torch.clamp(cols.index_select(0, fallback) - cur_max, min=0.0))
        e = torch.where(all_dup, fallback, best if full_sweep else cand.index_select(0, best))
        cur_max = torch.maximum(cur_max, cols.index_select(0, e)[0])
        chosen.index_fill_(0, e, True)
        new_idx[t:t + 1] = e
        new_gains[t:t + 1] = torch.where(all_dup, g_fallback, g_best)
    indices = torch.cat([init_idx, new_idx])
    gains = torch.cat([init_gains, new_gains])
    weights = _cluster_weights(sim, indices)
    coverage = torch.sum(torch.max(sim, dim=1).values - cur_max)
    return FLResult(indices, gains, weights, coverage)


@dataclasses.dataclass(frozen=True)
class StochasticConfig(EngineConfig):
    """Stochastic greedy.

    Attributes:
      delta: failure probability δ of the per-step sample; the sample size
        is (n/r)·ln(1/δ), clamped to n (δ→0 reduces to exact greedy).
    """

    name: ClassVar[str] = "stochastic"
    delta: float = 0.01


def sample_size(n: int, budget: int, delta: float) -> int:
    """m = min(n, max(1, ⌈n/r·ln(1/δ)⌉)), in the reference's float64."""
    return min(n, max(1, math.ceil(n / budget * math.log(1.0 / delta))))


@register_engine
class StochasticEngine(SelectionEngine):
    name = "stochastic"
    config_cls = StochasticConfig
    capabilities = Capabilities(
        exact=False,  # (1−1/e−δ) in expectation
        matrix_free=False,
        device_resident=True,
        supports_cover=False,
        supports_metrics=("l2", "cosine"),
        memory=lambda n, d: 8 * n * n,  # dist + sim, fp32 each
    )

    def select(
        self, feats, budget, *, metric="l2", init_selected=None, rng=None
    ) -> FLResult:
        dist = pairwise_distances(feats, metric)
        n = dist.shape[0]
        budget = int(min(budget, n))
        d_max = torch.max(dist) + 1e-6
        # the similarities stored column-major: the sampled columns are the
        # contiguous rows of sim.T
        sim = (d_max - dist).T.contiguous().T
        res = stochastic_greedy_fl(
            sim, budget, rng, sample_size(n, budget, self.config.delta),
            init_selected=init_selected,
        )
        return res._replace(coverage=coverage_l(dist, res.indices))
