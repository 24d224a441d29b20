"""SelectionEngine protocol, typed per-engine configs, shared FL math.

Port of ``repro.core.engines.base``.  Each engine module under
``repro_torch.core.engines`` defines a frozen ``EngineConfig`` dataclass
(its complete tuning surface, round-tripping through ``to_dict``/
``from_dict``), a ``SelectionEngine`` subclass implementing
``select(feats, budget, *, metric, init_selected, rng) -> FLResult``, and a
``Capabilities`` record the registry and ``CraigSelector`` gate on.

Engines take (n, d) fp32 tensors and compute on the tensors' device.
Metrics: ``'l2'`` natively; ``'cosine'`` through l2 on unit-normalized
features for the matrix-free engines (``normalize_for_metric``), with the
residual converted back to cosine-distance units
(``cosine_residual_coverage``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, NamedTuple

import numpy as np
import torch

__all__ = [
    "FLResult",
    "EngineConfig",
    "Capabilities",
    "SelectionEngine",
    "pairwise_distances",
    "normalize_for_metric",
    "cosine_residual_coverage",
    "facility_location_value",
    "coverage_l",
    "assign_and_weights",
]


class FLResult(NamedTuple):
    """Result of a greedy facility-location run.

    Attributes:
      indices:  (r,) int64 — selected ground-set indices, in greedy order.
      gains:    (r,) float32 — marginal gain of each selection.
      weights:  (r,) float32 — γ_j cluster sizes (paper Alg. 1 line 8);
                sum(weights) == n.
      coverage: () float32 — final L(S) = Σ_i min_{j∈S} d_ij (paper Eq. 8).
    """

    indices: torch.Tensor
    gains: torch.Tensor
    weights: torch.Tensor
    coverage: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Base of every typed engine config (frozen, fully defaulted).

    Subclasses set the class attribute ``name`` to their registry key.
    ``to_dict``/``from_dict`` round-trip exactly (JSON-able).
    """

    name: ClassVar[str] = "?"

    def to_dict(self) -> dict:
        """JSON-able ``{"name": ..., **fields}`` snapshot."""
        return {"name": type(self).name, **dataclasses.asdict(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        """Inverse of :meth:`to_dict`; dispatches on ``d['name']``."""
        from repro_torch.core.engines.registry import engine_config_from_dict

        return engine_config_from_dict(d)


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a SelectionEngine can do — the registry's dispatch surface.

    Attributes:
      exact: reproduces exact greedy at the engine's default config.
      matrix_free: never materializes the dense (n, n) similarity.
      device_resident: ``select`` keeps the (n, d) features on their device
        end to end; only the small outputs cross to the host (the
        reference's ``jit_safe``).
      supports_cover: implements submodular cover (paper Eq. 12).
      supports_metrics: accepted ``metric=`` values.
      memory: ``memory(n, d) -> bytes`` peak-footprint estimate.
    """

    exact: bool
    matrix_free: bool
    device_resident: bool
    supports_cover: bool
    supports_metrics: tuple[str, ...]
    memory: Callable[[int, int], int]


class SelectionEngine:
    """A greedy facility-location maximizer behind the common protocol."""

    name: ClassVar[str]
    config_cls: ClassVar[type[EngineConfig]]
    capabilities: ClassVar[Capabilities]

    def __init__(self, config: EngineConfig | None = None):
        if config is None:
            config = self.config_cls()
        if not isinstance(config, self.config_cls):
            raise TypeError(
                f"engine {self.name!r} expects {self.config_cls.__name__}, "
                f"got {type(config).__name__}"
            )
        self.config = config

    def select(
        self,
        feats: torch.Tensor,
        budget: int,
        *,
        metric: str = "l2",
        init_selected=None,
        rng=None,
    ) -> FLResult:
        """Select ``budget`` medoids from (n, d) proxy features (see the
        reference for the argument contract)."""
        raise NotImplementedError

    def select_cover(
        self, feats: torch.Tensor, epsilon: float, *, metric: str = "l2"
    ) -> FLResult:
        """Submodular cover (paper Eq. 12): grow S until L(S) ≤ epsilon."""
        raise ValueError(
            f"engine {self.name!r} does not support mode='cover' "
            "(Capabilities.supports_cover is False)"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}({self.config!r})"


# ---------------------------------------------------------------------------
# Shared similarity / objective math
# ---------------------------------------------------------------------------


def pairwise_distances(feats: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Dense (n, n) proxy-gradient dissimilarity matrix d_ij (paper Eq. 7/9).

    A plain ``torch.matmul``, as the reference leaves it to jnp.
    """
    feats = feats.float()
    if metric == "l2":
        sq = torch.sum(feats * feats, dim=-1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (feats @ feats.T)
        return torch.sqrt(torch.clamp(d2, min=0.0))
    if metric == "cosine":
        nf = feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-12)
        return 1.0 - nf @ nf.T
    raise ValueError(f"unknown metric {metric!r}")


def normalize_for_metric(feats: torch.Tensor, metric: str) -> torch.Tensor:
    """'l2' passes through; 'cosine' unit-normalizes rows."""
    if metric == "l2":
        return feats
    if metric == "cosine":
        feats = feats.float()
        return feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-12)
    raise ValueError(f"unknown metric {metric!r}")


def cosine_residual_coverage(
    feats_normalized: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """L(S) = Σ_i min_{j∈S} (1 − cos θ_ij) from unit-normalized features
    (‖x − m‖² = 2·(1 − cos θ) on the sphere)."""
    sel = feats_normalized[indices]
    sq_x = torch.sum(feats_normalized * feats_normalized, dim=-1)
    sq_s = torch.sum(sel * sel, dim=-1)
    d2 = torch.clamp(
        sq_x[:, None] + sq_s[None, :] - 2.0 * (feats_normalized @ sel.T),
        min=0.0,
    )
    return torch.sum(torch.min(d2, dim=1).values) / 2.0


def facility_location_value(sim: torch.Tensor, selected_mask: torch.Tensor) -> torch.Tensor:
    """F(S) = Σ_i max_{j∈S} s_ij with the empty-set convention F(∅) = 0
    (an empty row maximum is −inf, clamped to 0).

    Args:
      sim: (n, n) similarities (s_ij ≥ 0; the s0 baseline already subtracted).
      selected_mask: (n,) bool.
    """
    neg = torch.tensor(float("-inf"), dtype=sim.dtype, device=sim.device)
    best = torch.max(torch.where(selected_mask[None, :], sim, neg), dim=1).values
    return torch.sum(torch.clamp(best, min=0.0))


def coverage_l(dist: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """L(S) = Σ_i min_{j∈S} d_ij  (paper Eq. 8) for selected ``indices``."""
    return torch.sum(torch.min(dist[:, indices], dim=1).values)


def _counts(assign: torch.Tensor, r: int, pw=None) -> torch.Tensor:
    """γ_j = Σ_{i assigned to j} w_i; exact integers in fp32 for unit w."""
    if pw is None:
        return torch.bincount(assign, minlength=r).to(torch.float32)
    return torch.zeros((r,), dtype=torch.float32, device=assign.device).index_add_(
        0, assign, pw.float()
    )


def assign_and_weights(dist_to_sel: torch.Tensor):
    """Given (n, r) distances to selected medoids, return (assignment, γ)."""
    assign = torch.argmin(dist_to_sel, dim=1)  # first minimum, as jnp
    return assign, _counts(assign, dist_to_sel.shape[1])


def _as_init_idx(init_selected, budget: int, device) -> torch.Tensor:
    """Validate a warm-start prefix: (r₀,) int64 with r₀ ≤ budget."""
    if isinstance(init_selected, torch.Tensor):
        idx = init_selected.to(device=device, dtype=torch.int64)
    else:
        idx = torch.tensor(np.asarray(init_selected, np.int64), device=device)
    if idx.dim() != 1:
        raise ValueError("init_selected must be 1-D")
    if idx.shape[0] > budget:
        raise ValueError(
            f"init_selected has {idx.shape[0]} elements > budget {budget}"
        )
    return idx


def _replay_prefix(init_selected, budget: int, n: int, col_fn, pw=None, *,
                   device):
    """Replay a warm-start prefix's cover state (shared by the engines).

    ``col_fn(e)`` returns the (n,) similarity column of element e (a 0-d
    index tensor); marginal gains are recorded in prefix order (optionally
    ``pw``-weighted), exactly as a cold greedy run would have produced them.

    Returns (init_idx (r₀,), init_gains (r₀,), cur_max (n,), chosen (n,)).
    """
    cur_max = torch.zeros((n,), dtype=torch.float32, device=device)
    chosen = torch.zeros((n,), dtype=torch.bool, device=device)
    if init_selected is None:
        return (
            torch.zeros((0,), dtype=torch.int64, device=device),
            torch.zeros((0,), dtype=torch.float32, device=device),
            cur_max,
            chosen,
        )
    init_idx = _as_init_idx(init_selected, budget, device)
    gains = []
    for t in range(init_idx.shape[0]):
        col = col_fn(init_idx[t])
        gap = torch.clamp(col - cur_max, min=0.0)
        gains.append(torch.sum(gap) if pw is None else pw @ gap)
        cur_max = torch.maximum(cur_max, col)
    chosen[init_idx] = True
    init_gains = (
        torch.stack(gains) if gains
        else torch.zeros((0,), dtype=torch.float32, device=device)
    )
    return init_idx, init_gains, cur_max, chosen


def _cluster_weights(
    sim: torch.Tensor, indices: torch.Tensor, point_weights=None
) -> torch.Tensor:
    """γ_j = Σ_{i : j = argmax_{s∈S} s_is} w_i (paper Alg. 1 line 8)."""
    assign = torch.argmax(sim[:, indices], dim=1)  # first maximum, as jnp
    return _counts(assign, indices.shape[0], point_weights)
