"""CRAIG selector (paper Alg. 1 + §3.3 budgeted variant + §5 per-class mode).

Port of ``repro.core.craig``: proxy features → greedy facility location →
(indices, γ weights, ε estimate).  The greedy maximizer is a pluggable
``SelectionEngine`` named by ``CraigConfig.engine``: ``'auto'`` (the
policy in ``engines.auto_engine_config``, keyed on the selector's device)
a typed ``EngineConfig``, or a deprecated legacy string with the flat
knobs ``CraigConfig`` inherits, which ``engines.legacy`` maps onto the
typed config with a ``DeprecationWarning``.

The selector runs on its ``device`` — the card unless the caller asks for
the CPU.  Host inputs are moved there; only the (n,) finite mask and the
small index/weight outputs come back.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.engines import (
    EngineConfig,
    auto_engine_config,
    make_engine,
    normalize_for_metric,
)
from repro_torch.core.engines.legacy import LegacyEngineKnobs, resolve_engine_config

__all__ = ["CraigConfig", "CoresetSelection", "CraigSelector", "_apportion_budgets"]

def _apportion_budgets(counts: np.ndarray, total_budget: int) -> np.ndarray:
    """Largest-remainder apportionment of ``total_budget`` across classes.

    Invariants: Σ budgets == min(total_budget, Σ counts); budgets ≤ counts;
    every class gets ≥ 1 while feasible, else the most frequent classes win
    the singletons (ties → lower class index).
    """
    counts = np.asarray(counts, np.int64)
    k = len(counts)
    total = int(min(int(total_budget), int(counts.sum())))
    budgets = np.zeros(k, np.int64)
    if total <= 0:
        return budgets
    if total < k:
        order = np.lexsort((np.arange(k), -counts))
        budgets[order[:total]] = 1
        return budgets
    raw = counts / counts.sum() * total
    budgets = np.minimum(np.maximum(np.floor(raw).astype(np.int64), 1), counts)
    while budgets.sum() < total:
        room = budgets < counts
        frac = np.where(room, raw - budgets, -np.inf)
        budgets[int(np.argmax(frac))] += 1
    while budgets.sum() > total:
        cand = np.where(budgets > 1, budgets, -1)
        budgets[int(np.argmax(cand))] -= 1
    return budgets


@dataclasses.dataclass(frozen=True, kw_only=True)
class CraigConfig(LegacyEngineKnobs):
    """Configuration for CRAIG subset selection.

    Attributes:
      mode: 'budget' (|S| ≤ fraction·n, paper Eq. 14) or 'cover'
        (grow until L(S) ≤ epsilon, paper Eq. 12).
      fraction: subset fraction r/n for 'budget' mode.
      epsilon: target coverage for 'cover' mode (same units as d_ij).
      metric: 'l2' (the paper's) or 'cosine'.
      engine: ``'auto'`` (default), a typed ``EngineConfig``
        (``MatrixConfig()``, ``DeviceConfig(...)``, ``StochasticConfig(...)``),
        or a deprecated legacy string ``'matrix'|'lazy'|'stochastic'|
        'features'|'sparse'|'device'`` mapped with the flat knobs inherited
        from ``LegacyEngineKnobs`` (a ``DeprecationWarning``).
      per_class: stratified per-class selection (paper §5).
      seed: seed of the stochastic engine's candidate draws.
      validate_features: 'raise' | 'drop' | 'off' NaN/Inf guard.
    """

    mode: Literal["budget", "cover"] = "budget"
    fraction: float = 0.1
    epsilon: float = 0.0
    metric: str = "l2"
    engine: str | EngineConfig = "auto"
    per_class: bool = True
    seed: int = 0
    validate_features: Literal["raise", "drop", "off"] = "raise"


@dataclasses.dataclass
class CoresetSelection:
    """A selected weighted coreset (host numpy arrays).

    indices/weights are aligned; ``order`` is the greedy selection order.
    ``engine`` is the resolved ``EngineConfig.to_dict()`` provenance.
    """

    indices: np.ndarray  # (r,) int64 into the pool
    weights: np.ndarray  # (r,) float32, sum == n
    order: np.ndarray  # (r,) — positions, greedy order
    coverage: float
    epsilon_hat: float
    per_class_sizes: dict[int, int] | None = None
    engine: dict | None = None
    n_dropped: int = 0

    @property
    def size(self) -> int:
        return int(self.indices.shape[0])

    def normalized_weights(self) -> np.ndarray:
        """Weights scaled to mean 1 (γ_j · r / Σγ) for weighted-loss
        training, computed in float64."""
        w = self.weights.astype(np.float64)
        return (w * (len(w) / max(w.sum(), 1e-12))).astype(np.float32)


class CraigSelector:
    """Selects weighted coresets from gradient-proxy features.

    Usage::

        sel = CraigSelector(CraigConfig(fraction=0.1))        # on the card
        sel = CraigSelector(CraigConfig(fraction=0.1), device="cpu")
        coreset = sel.select(proxy_feats, labels=labels)
    """

    def __init__(self, config: CraigConfig, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)

    # -- public API ---------------------------------------------------------

    def resolve_engine(self, n: int, *, _stacklevel: int = 2) -> EngineConfig:
        """The typed engine config a greedy run over ``n`` points uses
        (``_stacklevel`` points a legacy-string warning at the caller)."""
        typed = resolve_engine_config(self.config, _stacklevel=_stacklevel + 1)
        if typed is None:
            typed = auto_engine_config(n, backend=self.device.type, mode=self.config.mode)
        return typed

    def select(
        self,
        feats,
        labels: np.ndarray | None = None,
        init_selected: np.ndarray | None = None,
    ) -> CoresetSelection:
        """Select a weighted coreset from (n, d) proxy features.

        Args:
          feats: (n, d) numpy array or tensor; moved to the selector's device.
          labels: optional (n,) integer class labels (per-class mode).
          init_selected: optional warm-start medoids (indices into
            ``feats``, greedy order) whose cover state is replayed.
        """
        cfg = self.config
        feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
        n_orig = feats.shape[0]
        init = self._clean_init(init_selected, n_orig)
        feats, labels, init, keep_idx = self._validated(feats, labels, init)
        n = feats.shape[0]
        if cfg.per_class and labels is not None:
            labels = np.asarray(labels)
            # engine='auto' keys on the pool one greedy run sweeps — here
            # the largest class
            counts = np.unique(labels, return_counts=True)[1]
            engine_cfg = self.resolve_engine(int(counts.max()), _stacklevel=3)
            sel = self._select_per_class(feats, labels, init, engine_cfg)
        else:
            if cfg.per_class:
                warnings.warn(
                    "per_class=True but no labels were provided; falling "
                    "back to flat (unstratified) selection — pass labels to "
                    "CraigSelector.select for the paper-§5 per-class mode",
                    UserWarning,
                    stacklevel=2,
                )
            engine_cfg = self.resolve_engine(n, _stacklevel=3)
            idx, w, _, coverage = self._select_flat(
                feats, self._budget(n), init, engine_cfg
            )
            sel = CoresetSelection(
                indices=idx,
                weights=w,
                order=np.arange(len(idx)),
                coverage=coverage,
                epsilon_hat=coverage,
                engine=engine_cfg.to_dict(),
            )
        if keep_idx is not None:
            sel.indices = keep_idx[sel.indices]
            sel.n_dropped = int(n_orig - len(keep_idx))
        return sel

    def select_distributed(self, feats, mesh, axis_name: str = "data") -> CoresetSelection:
        """Two-round selection over ``mesh[axis_name]`` (``core.distributed``)
        with the output contract of :meth:`select`.

        ``feats`` is the global (n, d) pool; budgets derive from
        ``config.fraction``.  Round 1 runs the engine the config resolves
        to (``ROUND1_ENGINES``; 'auto' picks per *shard* pool size, and
        lazy or stochastic fall back to the auto pick with a warning).
        ``metric='cosine'`` unit-normalizes the pool and reports coverage
        in cosine-distance units.  ``mesh`` is a ``launch.mesh.Mesh`` or a
        one-axis ``DeviceMesh`` of ranks, each calling this with the same
        pool (``distributed_select``).
        """
        from repro_torch.core.distributed import (
            distributed_select,
            is_rank_mesh,
            rank_device,
            resolve_round1_config,
        )

        cfg = self.config
        if cfg.mode == "cover":
            raise ValueError(
                "select_distributed supports mode='budget' only — cover "
                "needs exact prefix coverages on the global pool"
            )
        feats = normalize_for_metric(
            torch.as_tensor(feats, dtype=torch.float32).to(self.device), cfg.metric
        )
        n = feats.shape[0]
        if is_rank_mesh(mesh):
            n_shards, shard_device = mesh.size(), rank_device(mesh)
        else:
            n_shards, shard_device = int(mesh.shape[axis_name]), mesh.axis_devices(axis_name)[0]
        r_final = self._budget(n)
        r_local = max(1, min(n // n_shards, int(r_final * 2 / n_shards) + 1))
        typed = resolve_engine_config(cfg)
        engine_cfg = resolve_round1_config(
            "auto" if typed is None else typed, {}, n // n_shards, device=shard_device,
        )
        res = distributed_select(
            feats, mesh, r_local=r_local, r_final=r_final, axis_name=axis_name,
            local_engine=engine_cfg,
            # Σ min ‖x−m‖²/2 on the unit sphere is Σ min (1 − cos θ)
            squared_coverage=cfg.metric == "cosine",
        )
        return self._distributed_result(res, r_final, engine_cfg.to_dict())

    def select_tree(
        self,
        feats,
        fanouts: tuple[int, ...],
        *,
        mesh=None,
        compress: str = "int8",
        r_node: int | None = None,
    ) -> CoresetSelection:
        """Hierarchical tree selection (``distributed.tree_select``) with the
        output contract of :meth:`select`.

        ``fanouts`` is the leaf → root merge tree (``(n_shards,)`` equals
        the two-round path bit for bit on the fp32 wire); ``mesh=None``
        runs the host driver on the selector's device (ragged pools fine),
        a level-axis mesh from ``tree_select.tree_mesh`` the mesh driver.
        Candidates ship as int8 rows by default (``compress='none'``: fp32).
        ``CoresetSelection.engine`` is a ``TreeSelectConfig`` dict with the
        leaf engine nested under ``local``.
        """
        from repro_torch.core.distributed import resolve_round1_config
        from repro_torch.distributed.tree_select import (
            TreeSelectConfig,
            TreeTopology,
            tree_select_host,
            tree_select_mesh,
        )

        cfg = self.config
        if cfg.mode == "cover":
            raise ValueError(
                "select_tree supports mode='budget' only — cover needs "
                "exact prefix coverages on the global pool"
            )
        topology = TreeTopology(tuple(fanouts))
        feats = normalize_for_metric(
            torch.as_tensor(feats, dtype=torch.float32).to(self.device), cfg.metric
        )
        n = feats.shape[0]
        n_leaves = topology.n_leaves
        r_final = self._budget(n)
        r_local = max(1, min(n // n_leaves, int(r_final * 2 / n_leaves) + 1))
        typed = resolve_engine_config(cfg)
        leaf_device = self.device if mesh is None else mesh.flat_devices()[0]
        engine_cfg = resolve_round1_config(
            "auto" if typed is None else typed, {}, n // n_leaves, device=leaf_device
        )
        kwargs = dict(
            r_node=r_node, local_engine=engine_cfg, compress=compress,
            squared_coverage=cfg.metric == "cosine",
        )
        if mesh is None:
            res = tree_select_host(feats, topology, r_local, r_final, **kwargs)
        else:
            res = tree_select_mesh(feats, mesh, topology, r_local, r_final, **kwargs)
        # the host and mesh drivers have no process failure domain, so the
        # degradation fields keep their clean defaults
        provenance = TreeSelectConfig(
            fanouts=topology.fanouts, compress=compress, local=engine_cfg.to_dict(),
        )
        return self._distributed_result(res, r_final, provenance.to_dict())

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _distributed_result(res, r_final: int, engine: dict) -> CoresetSelection:
        coverage = float(res.coverage)
        return CoresetSelection(
            indices=res.indices.cpu().numpy().astype(np.int64),
            weights=res.weights.cpu().numpy().astype(np.float32),
            order=np.arange(r_final),
            coverage=coverage,
            epsilon_hat=coverage,
            engine=engine,
        )

    def _budget(self, n: int) -> int:
        return max(1, int(round(self.config.fraction * n)))

    def _validated(self, feats, labels, init):
        """NaN/Inf guard; returns (feats, labels, init, keep_idx)."""
        mode = self.config.validate_features
        if mode == "off":
            return feats, labels, init, None
        if mode not in ("raise", "drop"):
            raise ValueError(
                f"validate_features={mode!r} is not a policy; expected "
                "'raise', 'drop' or 'off'"
            )
        finite = torch.isfinite(feats).all(dim=1).cpu().numpy()
        if bool(finite.all()):
            return feats, labels, init, None
        bad = np.nonzero(~finite)[0]
        if mode == "raise":
            raise ValueError(
                f"{bad.size} of {finite.size} proxy feature rows contain "
                f"NaN/Inf (first bad rows: {bad[:8].tolist()}); a non-finite "
                "row silently poisons the facility-location argmax.  Fix the "
                "proxy/extraction or set "
                "CraigConfig(validate_features='drop') to drop-and-warn."
            )
        keep_idx = np.nonzero(finite)[0]
        if keep_idx.size == 0:
            raise ValueError(
                "every proxy feature row is NaN/Inf; nothing to select from"
            )
        warnings.warn(
            f"dropping {bad.size} NaN/Inf proxy feature rows before "
            f"selection (validate_features='drop'); first bad rows: "
            f"{bad[:8].tolist()}",
            UserWarning,
            stacklevel=3,
        )
        feats = feats[torch.as_tensor(keep_idx, device=feats.device)]
        if labels is not None:
            labels = np.asarray(labels)[keep_idx]
        if init is not None:
            pos = np.full(finite.size, -1, np.int64)
            pos[keep_idx] = np.arange(keep_idx.size)
            init = pos[init]
            init = init[init >= 0]
            if init.size == 0:
                init = None
        return feats, labels, init, keep_idx

    @staticmethod
    def _clean_init(init_selected, n: int) -> np.ndarray | None:
        """int64, unique (order-preserving), bounds-checked; None if empty."""
        if init_selected is None:
            return None
        init = np.asarray(init_selected, np.int64).ravel()
        if init.size == 0:
            return None
        if init.min() < 0 or init.max() >= n:
            raise ValueError(
                f"init_selected out of range [0, {n}): "
                f"[{init.min()}, {init.max()}]"
            )
        _, first = np.unique(init, return_index=True)
        return init[np.sort(first)]

    def _select_flat(self, feats, budget, init, engine_cfg):
        """One engine run; returns host (indices, weights, gains, coverage)."""
        cfg = self.config
        n = feats.shape[0]
        budget = min(budget, n)
        if init is not None:
            init = init[:budget]
        engine = make_engine(engine_cfg)
        caps = engine.capabilities
        if cfg.metric not in caps.supports_metrics:
            raise ValueError(
                f"engine {engine_cfg.name!r} supports metrics "
                f"{caps.supports_metrics}, got {cfg.metric!r}"
            )
        if cfg.mode == "cover":
            if not caps.supports_cover:
                raise ValueError(
                    "mode='cover' needs exact prefix coverages (paper "
                    f"Eq. 12); engine {engine_cfg.name!r} does not support "
                    "it (Capabilities.supports_cover) — use "
                    "engines.MatrixConfig()"
                )
            res = engine.select_cover(feats, cfg.epsilon, metric=cfg.metric)
        else:
            res = engine.select(
                feats, budget,
                metric=cfg.metric, init_selected=init, rng=cfg.seed,
            )
        idx = res.indices.cpu().numpy().astype(np.int64)
        if len(np.unique(idx)) != len(idx):
            raise AssertionError(
                f"engine {engine_cfg.name!r} selected duplicate indices "
                f"({len(idx) - len(np.unique(idx))} repeats)"
            )
        return (
            idx,
            res.weights.cpu().numpy().astype(np.float32),
            res.gains.cpu().numpy(),
            float(res.coverage),
        )

    def _select_per_class(self, feats, labels, init, engine_cfg):
        """Paper §5: select within each class, budgets ∝ class frequency."""
        n = feats.shape[0]
        classes = np.unique(labels)
        total_budget = min(self._budget(n), n)
        all_idx: list[np.ndarray] = []
        all_w: list[np.ndarray] = []
        coverage = 0.0
        sizes: dict[int, int] = {}
        counts = np.array([(labels == c).sum() for c in classes], np.int64)
        if self.config.mode == "cover":
            budgets = counts  # ε-driven sizes; no class is skipped
        else:
            budgets = _apportion_budgets(counts, total_budget)
        for c, b in zip(classes, budgets):
            sizes[int(c)] = 0
            if b == 0:
                continue
            pool = np.nonzero(labels == c)[0]
            sub_feats = feats[torch.as_tensor(pool, device=feats.device)]
            init_c = None
            if init is not None:
                own = init[np.isin(init, pool)]
                if own.size:
                    init_c = np.searchsorted(pool, own)
            idx, w, _, cov = self._select_flat(sub_feats, int(b), init_c, engine_cfg)
            all_idx.append(pool[idx])
            all_w.append(w)
            coverage += cov
            sizes[int(c)] = int(idx.shape[0])
        indices = np.concatenate(all_idx)
        weights = np.concatenate(all_w)
        if self.config.mode == "budget" and len(indices) != total_budget:
            raise AssertionError((len(indices), total_budget))
        # Σγ == n even when the budget cannot cover every class.
        if weights.sum() < n:
            weights = weights * (n / weights.sum())
        return CoresetSelection(
            indices=indices,
            weights=weights,
            order=np.arange(len(indices)),
            coverage=coverage,
            epsilon_hat=coverage,
            per_class_sizes=sizes,
            engine=engine_cfg.to_dict(),
        )
