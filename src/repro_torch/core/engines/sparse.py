"""Sparse top-k engine: O(n·k) memory, million-point pools.

Port of ``repro.core.engines.sparse``.  ``topk_graph`` builds the (n, k)
neighbour structure without the (n, n) matrix: the hand-written
``topk_sim`` kernel on a card, its blocked ``torch.topk`` twin elsewhere.
Greedy then maximizes the *sparsified* objective two ways with identical
selections: ``sparse_greedy_fl`` (host CSC lazy greedy in numpy, the
engine's ``select`` path) and ``greedy_fl_topk`` (a torch loop of (n, k)
scatter-adds; the reference's ``lax.scan``).  The exact γ assignment runs
on the features' device through the ``pairwise_l2`` kernel, where the
reference computes it on the host in numpy.

:data:`TIMINGS` sums the seconds of the three phases of
``sparse_greedy_fl_features`` over calls (graph build, host greedy, γ
assignment); callers zero it, as they do ``kernels.ops.LAUNCHES``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import ClassVar

import numpy as np
import torch

from repro_torch.core.engines.base import (
    Capabilities,
    EngineConfig,
    FLResult,
    SelectionEngine,
    normalize_for_metric,
)
from repro_torch.core.engines.registry import register_engine
from repro_torch.kernels import ops as kops

__all__ = [
    "SparseConfig",
    "SparseEngine",
    "TIMINGS",
    "assign_to_medoids",
    "topk_graph",
    "greedy_fl_topk",
    "sparse_greedy_fl",
    "sparse_greedy_fl_features",
]

# Seconds per phase of sparse_greedy_fl_features, summed over calls.
TIMINGS: dict[str, float] = {"graph_s": 0.0, "greedy_s": 0.0, "assign_s": 0.0}

# Bytes of one block of the (rows, r) distance matrix in the γ assignment.
ASSIGN_BLOCK_BYTES = 1 << 30


def topk_graph(
    feats: torch.Tensor,
    k: int,
    *,
    d_max=None,
    block_m: int = 2048,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k similarity graph: (vals (n, k) fp32 desc, idx (n, k) int32).

    Args:
      feats: (n, d) proxy features.
      k: neighbours per row (clamped to n); every row's list includes
        itself.
      d_max: similarity offset s = d_max − dist; defaults to the
        2·max‖x‖ + ε distance bound (as ``greedy_fl_features``).
      block_m: column tile of the plain twin.
      impl: 'auto' (the ``topk_sim`` kernel on a card, the twin on the
        CPU) | 'cuda' | 'torch' (the reference's 'pallas' | 'jax').
    """
    n = feats.shape[0]
    k = int(min(k, n))
    return kops.topk_sim(feats, k, d_max, impl=impl, block_m=block_m)


def greedy_fl_topk(vals: torch.Tensor, idx: torch.Tensor, budget: int) -> FLResult:
    """Exact greedy over the *sparsified* FL objective, in torch.

    Maximizes F̂(S) = Σ_i max(max_{j∈S∩nbr(i)} ŝ_ij, 0) over the top-k
    graph.  Per step every entry (i, j) adds relu(ŝ_ij − cur_max_i) to
    candidate j's gain through one (n, k) scatter-add: O(n·k) per step, no
    dense structure.  γ is graph-assigned: each point to its best selected
    neighbour, points with none to the first medoid; Σγ == n.
    """
    n, k = vals.shape
    dev = vals.device
    vals = vals.float()
    idx = idx.long()
    budget = int(min(budget, n))
    flat_i = idx.reshape(-1)
    cur_max = torch.zeros((n,), dtype=torch.float32, device=dev)
    chosen = torch.zeros((n,), dtype=torch.bool, device=dev)
    indices = torch.empty((budget,), dtype=torch.int64, device=dev)
    gains_out = torch.empty((budget,), dtype=torch.float32, device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    for t in range(budget):
        contrib = torch.clamp(vals - cur_max[:, None], min=0.0)
        gains = torch.zeros((n,), dtype=torch.float32, device=dev).index_add_(
            0, flat_i, contrib.reshape(-1))
        gains = torch.where(chosen, neg, gains)
        e = torch.argmax(gains).view(1)
        cov = torch.where(idx == e, vals, neg).max(dim=1).values
        cur_max = torch.maximum(cur_max, cov)
        chosen.index_fill_(0, e, True)
        indices[t:t + 1] = e
        gains_out[t:t + 1] = gains.index_select(0, e)

    # graph γ: each row to its best selected neighbour
    best = torch.where(chosen[idx], vals, neg)
    bv, bpos = best.max(dim=1)
    assigned = torch.gather(idx, 1, bpos[:, None])[:, 0]
    assigned = torch.where(torch.isfinite(bv), assigned, indices[0])
    slot = torch.zeros((n,), dtype=torch.int64, device=dev)
    slot[indices] = torch.arange(budget, device=dev)
    weights = torch.bincount(slot[assigned], minlength=budget).to(torch.float32)
    coverage = torch.sum(torch.clamp(vals[:, 0] - cur_max, min=0.0))
    return FLResult(indices, gains_out, weights, coverage)


def _csc_lazy_greedy(vals, idx, budget: int, init_selected=None):
    """Host lazy greedy (Minoux) over the top-k graph, walking CSC columns.

    Returns (sel (r,) int64, gains list of floats, cur_max (n,) fp64)."""
    vals = np.asarray(vals, np.float64)
    idx = np.asarray(idx, np.int64)
    n, k = vals.shape

    # CSC transpose: entries sorted by candidate column.
    flat_v = vals.ravel()
    flat_c = idx.ravel()
    flat_r = np.repeat(np.arange(n, dtype=np.int64), k)
    valid = flat_v > -1e29  # drop builder padding
    flat_v, flat_c, flat_r = flat_v[valid], flat_c[valid], flat_r[valid]
    order = np.argsort(flat_c, kind="stable")
    col_vals = flat_v[order]
    col_rows = flat_r[order]
    sorted_c = flat_c[order]
    indptr = np.searchsorted(sorted_c, np.arange(n + 1))
    cur_max = np.zeros(n)

    def col_gain(c: int) -> float:
        lo, hi = indptr[c], indptr[c + 1]
        return float(np.maximum(col_vals[lo:hi] - cur_max[col_rows[lo:hi]], 0.0).sum())

    def cover(c: int) -> None:
        lo, hi = indptr[c], indptr[c + 1]
        np.maximum.at(cur_max, col_rows[lo:hi], col_vals[lo:hi])

    indices: list[int] = []
    gains: list[float] = []
    if init_selected is not None:
        init = np.asarray(init_selected, np.int64)
        if init.shape[0] > budget:
            raise ValueError(
                f"init_selected has {init.shape[0]} elements > budget {budget}"
            )
        for c in init:
            c = int(c)
            indices.append(c)
            gains.append(col_gain(c))
            cover(c)
    r0 = len(indices)
    in_init = set(indices)
    # bincount sums in entry order, as the reference's np.add.at
    init_gain = np.bincount(
        sorted_c, weights=np.maximum(col_vals - cur_max[col_rows], 0.0), minlength=n
    )
    heap = [(-g, c, r0) for c, g in enumerate(init_gain.tolist()) if c not in in_init]
    heapq.heapify(heap)
    for t in range(r0, budget):
        while True:
            neg_g, c, stamp = heapq.heappop(heap)
            if stamp == t:
                break
            heapq.heappush(heap, (-col_gain(c), c, t))
        indices.append(c)
        gains.append(-neg_g)
        cover(c)
    return np.array(indices, np.int64), gains, cur_max


def _result(sel, gains, weights, coverage: float) -> FLResult:
    return FLResult(
        torch.from_numpy(np.asarray(sel, np.int64)),
        torch.tensor(gains, dtype=torch.float32),
        torch.from_numpy(np.asarray(weights, np.float32)),
        torch.tensor(coverage, dtype=torch.float32),
    )


def _exact_weights(assign, mind, budget: int, squared_coverage: bool):
    """γ and true L(S) from one assignment pass: Σ min d (l2 units) or
    Σ min d²/2 (cosine units on a unit-normalized pool)."""
    weights = np.bincount(assign, minlength=budget).astype(np.float32)
    coverage = float(np.sum(mind**2) / 2.0 if squared_coverage else mind.sum())
    return weights, coverage


def sparse_greedy_fl(
    vals,
    idx,
    budget: int,
    feats: torch.Tensor | None = None,
    init_selected=None,
    squared_coverage: bool = False,
) -> FLResult:
    """Host lazy greedy (Minoux) over the top-k graph, walking CSC columns.

    The (n, k) rows are transposed once into a CSC layout (for each
    candidate c, the rows that list c), so a gain evaluation touches only
    that column; with the priority queue most candidates are never
    re-evaluated.  fp64 on the host, as the reference.  Selections equal
    ``greedy_fl_topk``'s (same objective, ties to the lowest index).

    With ``feats``, γ and coverage come from the exact assignment of every
    point to its nearest medoid (``_blocked_assignment``, on the features'
    device); otherwise from the graph, with the residual similarity mass
    as coverage.
    ``init_selected`` warm-starts from a prefix; ``squared_coverage``
    (needs ``feats``) reports Σ min ‖x−m‖²/2, the cosine units on a
    unit-normalized pool.
    """
    if squared_coverage and feats is None:
        raise ValueError("squared_coverage needs feats for exact assignment")
    vals = np.asarray(vals, np.float64)
    idx = np.asarray(idx, np.int64)
    n = vals.shape[0]
    budget = int(min(budget, n))
    sel, gains, cur_max = _csc_lazy_greedy(vals, idx, budget, init_selected)
    if feats is not None:
        assign, mind = _blocked_assignment(feats, sel)
        return _result(sel, gains, *_exact_weights(assign, mind, budget, squared_coverage))
    in_sel = np.zeros(n, bool)
    in_sel[sel] = True
    slot_of = np.zeros(n, np.int64)
    slot_of[sel] = np.arange(budget)
    masked = np.where(in_sel[idx] & (vals > -1e29), vals, -np.inf)
    rows_hit = masked.max(axis=1) > -np.inf
    best_c = np.full(n, sel[0], np.int64)  # orphans → first medoid
    best_c[rows_hit] = idx[np.arange(n), masked.argmax(axis=1)][rows_hit]
    weights = np.bincount(slot_of[best_c], minlength=budget)
    coverage = float(np.maximum(vals[:, 0] - cur_max, 0.0).sum())
    return _result(sel, gains, weights, coverage)


def assign_to_medoids(
    feats: torch.Tensor, sel: torch.Tensor, block: int | None = None, *,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact nearest-selected-medoid assignment on the features' device.

    Distances of a block of rows to every medoid come from
    ``kops.pairwise_l2`` (the kernel on a card); a torch min per row picks
    the nearest, the first on ties.  The block keeps one (block, r) fp32
    distance matrix near :data:`ASSIGN_BLOCK_BYTES`.

    Returns (assign (n,) int64 positions into ``sel``, min_dist (n,)
    fp32), on the features' device.
    """
    sf = feats[sel.to(feats.device)]
    n, r = feats.shape[0], sf.shape[0]
    if block is None:
        block = max(1, ASSIGN_BLOCK_BYTES // (4 * r))
    assign, mind = [], []
    for lo in range(0, n, block):
        dist = kops.pairwise_l2(feats[lo:lo + block], sf, impl=impl)
        dmin, amin = torch.min(dist, dim=1)
        assign.append(amin)
        mind.append(dmin)
    return torch.cat(assign), torch.cat(mind)


def _blocked_assignment(
    feats: torch.Tensor, sel, block: int | None = None, *, impl: str = "auto"
) -> tuple[np.ndarray, np.ndarray]:
    """:func:`assign_to_medoids` of host indices ``sel``, returned on the
    host: (assign (n,) int64, min_dist (n,) float64)."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    sel_t = torch.as_tensor(np.asarray(sel, np.int64), device=feats.device)
    assign, mind = assign_to_medoids(feats, sel_t, block, impl=impl)
    return (assign.cpu().numpy().astype(np.int64),
            mind.cpu().numpy().astype(np.float64))


def sparse_greedy_fl_features(
    feats: torch.Tensor,
    budget: int,
    *,
    k: int = 64,
    d_max=None,
    impl: str = "auto",
    block_m: int = 2048,
    init_selected=None,
    squared_coverage: bool = False,
) -> FLResult:
    """End-to-end sparse engine: top-k graph, host lazy greedy, exact γ.

    O(n·k + n·block_m) peak memory for the graph; the assignment keeps one
    ~1 GB distance block.  ``impl`` picks the graph builder and the
    assignment's distances alike ('auto' | 'cuda' | 'torch').  Adds each
    phase's seconds to :data:`TIMINGS`.
    """
    feats = feats.float()
    n = feats.shape[0]
    budget = int(min(budget, n))
    t0 = time.perf_counter()
    vals, idx = topk_graph(feats, k, d_max=d_max, block_m=block_m, impl=impl)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    TIMINGS["graph_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    sel, gains, _ = _csc_lazy_greedy(vals, idx, budget, init_selected)
    TIMINGS["greedy_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    assign, mind = _blocked_assignment(feats, sel, impl=impl)
    TIMINGS["assign_s"] += time.perf_counter() - t0
    return _result(sel, gains, *_exact_weights(assign, mind, budget, squared_coverage))


@dataclasses.dataclass(frozen=True)
class SparseConfig(EngineConfig):
    """Sparse top-k graph greedy.

    Attributes:
      k: neighbours kept per point (clamped to n).  Larger k → closer to
        exact greedy (k == n is exact); memory scales as n·k.  The kernel
        takes k ≤ 128.
      impl: 'auto' (the ``topk_sim`` and ``pairwise_l2`` kernels on a card,
        their plain twins on the CPU) | 'cuda' | 'torch'.
      block_m: column tile of the plain graph builder.
    """

    name: ClassVar[str] = "sparse"
    k: int = 64
    impl: str = "auto"
    block_m: int = 2048


@register_engine
class SparseEngine(SelectionEngine):
    name = "sparse"
    config_cls = SparseConfig
    capabilities = Capabilities(
        exact=False,  # exact on the k-NN graph; == exact greedy at k = n
        matrix_free=True,
        device_resident=False,  # host CSC lazy greedy
        supports_cover=False,
        supports_metrics=("l2", "cosine"),  # cosine via normalized l2
        memory=lambda n, d: 8 * n * 64 + 4 * n * 2048,
    )

    def select(
        self, feats, budget, *, metric="l2", init_selected=None, rng=None
    ) -> FLResult:
        cfg = self.config
        feats = normalize_for_metric(feats, metric)
        # cosine pools are unit-normalized, so Σ min ‖x−m‖²/2 from the
        # assignment pass is Σ min (1 − cos θ), the dense engines' units
        return sparse_greedy_fl_features(
            feats,
            budget,
            k=cfg.k,
            impl=cfg.impl,
            block_m=cfg.block_m,
            init_selected=init_selected,
            squared_coverage=metric == "cosine",
        )
