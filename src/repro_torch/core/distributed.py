"""Two-round distributed CRAIG selection (GreeDi-style) over a mesh.

Port of ``repro.core.distributed``.  The reference maps its rounds over a
``shard_map`` axis; here they are explicit stages over the shards of a
``repro_torch.launch.mesh.Mesh`` — the single-controller analogue, one
process driving every shard, each shard's work on that shard's device
(several shards may share one device).  ``all_gather(tiled=True)``
becomes a concatenation in shard order on the first shard's device, the
replicated merge runs once, and ``psum`` becomes a sum in shard order.  A
multi-process mesh (one rank per card over NCCL) is a later item
(ROADMAP.md queue 1).

  Round 1 (local): every shard runs greedy facility location over its
      partition of the pool, selecting ``r_local`` candidates with local γ
      weights.  The body is picked by a typed ``EngineConfig`` from
      ``ROUND1_ENGINES``; ``'auto'`` resolves it per *shard* pool size.
  Round 2 (merge): candidate features and γ weights are gathered
      (shards·r_local ≪ n) and a *weighted* greedy FL — each candidate
      counts γ_c points — selects the final ``r_final`` medoids.
  Re-weighting: every shard assigns its points to the final medoids and
      the per-medoid counts are summed, so Σγ = n over the whole pool.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core.engines import (
    DeviceConfig,
    EngineConfig,
    FeaturesConfig,
    MatrixConfig,
    SparseConfig,
    auto_engine_config,
)
from repro_torch.core.engines.base import pairwise_distances
from repro_torch.core.engines.device import greedy_fl_device
from repro_torch.core.engines.features import greedy_fl_features
from repro_torch.core.engines.legacy import resolve_distributed_engine
from repro_torch.core.engines.matrix import greedy_fl_matrix
from repro_torch.core.engines.sparse import assign_to_medoids, greedy_fl_topk, topk_graph
from repro_torch.kernels import ops as kops

__all__ = [
    "DistributedSelection",
    "distributed_select",
    "local_then_merge",
    "make_distributed_extract",
    "ROUND1_ENGINES",
    "normalize_round1_config",
    "resolve_round1_config",
    "leaf_round",
    "merge_round",
    "reweight",
    "run_tree",
    "shard_rows",
    "leaf_bounds",
    "check_candidate_counts",
    "check_even_shards",
]

# Engines with a distributed round-1 body.  The host-side lazy greedy and
# the sampled stochastic greedy have none; callers fall back to 'auto'.
ROUND1_ENGINES = ("matrix", "features", "sparse", "device")


def normalize_round1_config(ec: EngineConfig, device: torch.device) -> EngineConfig:
    """Pin a round-1 config to what its body runs on ``device``.

    The kernel routes (``gains_impl`` of features/device, ``impl`` of
    sparse) resolve their 'auto' to the route the shard's device takes —
    'cuda' on a card, 'torch' on the CPU — so the provenance records the
    real path.  An explicit route is honoured ('cuda' on a CPU shard
    raises).  The reference pins these knobs to 'jax' because Pallas
    cannot launch inside ``shard_map``; the port has no such limit, and on
    the CPU its provenance equals the reference's under
    ``engines.legacy.IMPL_FROM_REFERENCE``.
    """
    for attr in ("gains_impl", "impl"):
        if hasattr(ec, attr):
            ec = dataclasses.replace(
                ec, **{attr: kops.resolve_impl(getattr(ec, attr), device)}
            )
    return ec


def resolve_round1_config(
    local_engine, legacy_knobs: dict, n_local: int, *, device: torch.device
) -> EngineConfig:
    """The one resolve pipeline for round-1 engine configs.

    Shared by ``distributed_select``, ``local_then_merge``'s legacy
    surface, the tree drivers and ``CraigSelector.select_distributed``/
    ``select_tree``: legacy strings and knobs shim-map with a
    ``DeprecationWarning``, ``'auto'`` resolves per shard pool size on the
    shard's backend, engines with no round-1 body (``lazy``,
    ``stochastic``) warn and fall back to the auto pick, and the result is
    pinned to what the body runs (:func:`normalize_round1_config`).
    Idempotent on a resolved config.
    """
    device = torch.device(device)
    ec = resolve_distributed_engine(local_engine, legacy_knobs)
    if ec is None:  # 'auto': the shard's pool size drives the pick
        ec = auto_engine_config(max(1, n_local), backend=device.type)
    elif ec.name not in ROUND1_ENGINES:
        replacement = auto_engine_config(max(1, n_local), backend=device.type)
        warnings.warn(
            f"engine {ec.name!r} has no distributed round-1 body; "
            f"distributed round 1 uses {replacement!r} instead "
            f"(round-1 engines: {ROUND1_ENGINES})",
            UserWarning,
            stacklevel=3,
        )
        ec = replacement
    return normalize_round1_config(ec, device)


def make_distributed_extract(select_fn, mesh, axis_name: str = "data"):
    """Data-parallel megabatch proxy extraction.

    Returns ``fn(params, batches) → (M·B, D)`` where ``batches`` is a dict
    of tensors with leading dims (M, B) and M divisible by the
    ``axis_name`` size: shard s runs the one scan body
    (``core.extract.make_scan_extract``) over its contiguous slice of the
    M batches on its device, with the parameters replicated there, and the
    features concatenate in shard order on the first shard's device — pool
    order, never through the host.
    """
    from repro_torch.core.extract import make_scan_extract

    scan = make_scan_extract(select_fn)  # the one scan body (bit parity)
    devices = mesh.axis_devices(axis_name)

    def fn(params: dict, batches: dict) -> torch.Tensor:
        m = next(iter(batches.values())).shape[0]
        if m % len(devices):
            raise ValueError(
                f"{m} batches do not split over the {len(devices)}-shard "
                f"axis {axis_name!r}"
            )
        per = m // len(devices)
        replicas: dict[torch.device, dict] = {}
        outs = []
        for s, dev in enumerate(devices):
            if dev not in replicas:
                replicas[dev] = {k: v.to(dev) for k, v in params.items()}
            shard = {k: v[s * per:(s + 1) * per].to(dev) for k, v in batches.items()}
            outs.append(scan(replicas[dev], shard).to(devices[0]))
        return torch.cat(outs, dim=0)

    return fn


class DistributedSelection(NamedTuple):
    indices: torch.Tensor  # (r_final,) int64 — global pool indices
    weights: torch.Tensor  # (r_final,) float32 — Σ == n_global
    coverage: torch.Tensor  # () float32 — global L(S)


def check_candidate_counts(
    n_local: int,
    n_nodes: int,
    r_local: int,
    r_final: int,
    *,
    where: str = "distributed_select",
) -> None:
    """Candidate-count invariants of a local-select → merge level.

    A greedy engine asked for a budget past its pool size selects
    duplicates, which then poison the merge round; these audits turn
    that into errors while every count is still a Python int:

      * ``r_local ≤ n_local`` — a shard cannot yield more candidates than
        it has points;
      * ``n_nodes · r_local ≥ r_final`` — the merge must see at least
        ``r_final`` distinct candidates.
    """
    if r_final < 1 or r_local < 1:
        raise ValueError(
            f"{where}: budgets must be ≥ 1 (r_local={r_local}, "
            f"r_final={r_final})"
        )
    if r_local > n_local:
        raise ValueError(
            f"{where}: r_local={r_local} exceeds the shard pool size "
            f"n_local={n_local} — a greedy run past its pool size selects "
            f"duplicate candidates; lower r_local to ≤ {n_local} or use "
            "fewer/larger shards"
        )
    if n_nodes * r_local < r_final:
        raise ValueError(
            f"{where}: the merge round would see only "
            f"{n_nodes}×{r_local}={n_nodes * r_local} candidates, fewer "
            f"than r_final={r_final} — raise r_local to ≥ "
            f"{-(-r_final // n_nodes)} so the final greedy has enough "
            "distinct candidates"
        )


def check_even_shards(n: int, n_shards: int, *, where: str) -> None:
    """Ragged-shard audit: the mesh drivers split dim 0 evenly, and a
    silent pad or truncation would fabricate or drop pool points."""
    if n % n_shards != 0:
        raise ValueError(
            f"{where}: pool size n={n} is not divisible by the "
            f"{n_shards}-shard mesh axis — shard_map cannot split it "
            f"evenly and padding would fabricate phantom pool points.  "
            f"Trim the pool to {n - n % n_shards} or use "
            "repro_torch.distributed.tree_select.tree_select_host, which "
            "supports ragged leaf shards"
        )


def shard_rows(feats, bounds: Sequence[tuple[int, int]], devices) -> list[torch.Tensor]:
    """One fp32 tensor per ``(lo, hi)`` row range of ``feats``, each a fresh
    allocation on its device.  Every driver builds its shards here, so a
    shard's products see the same operands whichever driver runs them."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    out = []
    for (lo, hi), dev in zip(bounds, devices):
        rows = torch.arange(lo, hi, device=feats.device)
        out.append(feats.index_select(0, rows).to(dev))
    return out


def _local_round(feats: torch.Tensor, r_local: int):
    """Round 1 on one shard: dense greedy FL over the shard's distances."""
    dist = pairwise_distances(feats)
    d_max = torch.max(dist) + 1e-6
    res = greedy_fl_matrix(d_max - dist, r_local)
    return res.indices, res.weights


def _local_round_sparse(feats: torch.Tensor, r_local: int, cfg: SparseConfig):
    """Round 1 on one shard via the top-k graph — O(n_local·k) memory.

    The greedy runs on the sparsified objective (``greedy_fl_topk``, on
    the shard's device); γ is then exact: every local point goes to its
    nearest selected medoid, through ``pairwise_l2`` blocks as in the
    sparse engine.
    """
    vals, idx = topk_graph(feats, cfg.k, impl=cfg.impl, block_m=cfg.block_m)
    res = greedy_fl_topk(vals, idx, r_local)
    del vals, idx
    assign, _ = assign_to_medoids(feats, res.indices, impl=cfg.impl)
    return res.indices, torch.bincount(assign, minlength=r_local).to(torch.float32)


def _local_round_device(feats: torch.Tensor, r_local: int, cfg: DeviceConfig):
    """Round 1 on one shard via the device-resident fused greedy."""
    res = greedy_fl_device(
        feats, r_local, q=cfg.q, gains_impl=cfg.gains_impl,
        stale_tol=cfg.stale_tol, tile_dtype=cfg.tile_dtype,
    )
    return res.indices, res.weights


def _local_round_features(feats: torch.Tensor, r_local: int, cfg: FeaturesConfig):
    """Round 1 on one shard via the matrix-free blocked greedy."""
    res = greedy_fl_features(
        feats, r_local, gains_impl=cfg.gains_impl, block_n=cfg.block_n
    )
    return res.indices, res.weights


def leaf_round(feats: torch.Tensor, r_local: int, engine_config: EngineConfig | None):
    """One local selection: ``r_local`` candidates and local γ from ``feats``.

    The level-reusable round-1 body: the two-round path's round 1 and every
    leaf of the hierarchical tree (``distributed.tree_select``) dispatch
    through here.  ``engine_config`` is one of ``ROUND1_ENGINES``
    (resolved by :func:`resolve_round1_config`); None means the dense
    matrix round.

    Returns ``(local_idx (r_local,) int64, local_w (r_local,))`` with
    Σ local_w == n_local, on ``feats``' device.
    """
    ec = engine_config if engine_config is not None else MatrixConfig()
    if isinstance(ec, SparseConfig):
        return _local_round_sparse(feats, r_local, ec)
    if isinstance(ec, DeviceConfig):
        return _local_round_device(feats, r_local, ec)
    if isinstance(ec, FeaturesConfig):
        return _local_round_features(feats, r_local, ec)
    if isinstance(ec, MatrixConfig):
        return _local_round(feats, r_local)
    raise ValueError(
        f"engine {ec.name!r} has no distributed round-1 body; "
        f"round-1 engines: {ROUND1_ENGINES}"
    )


def merge_round(cand_feats: torch.Tensor, cand_w: torch.Tensor, budget: int):
    """One merge level: weighted greedy FL over a gathered candidate union.

    The two-round path calls it once at the root; the tree calls it at
    every non-leaf node.  Each candidate counts γ_c points.  Returns the
    weighted ``FLResult``: ``indices`` are positions into the union,
    ``weights`` the re-aggregated γ (Σ weights == Σ cand_w).
    """
    dist = pairwise_distances(cand_feats)
    d_max = torch.max(dist) + 1e-6
    sim = d_max - dist
    del dist
    return greedy_fl_matrix(sim, budget, point_weights=cand_w)


def reweight(feats_local: torch.Tensor, medoids: torch.Tensor, squared_coverage: bool):
    """Exact re-weighting of one shard against the final medoids.

    Returns ``(counts (r,), coverage ())``: how many of the shard's points
    each medoid is nearest to (the first on ties), and Σ min ‖x − m‖
    (or Σ min ‖x − m‖²/2 with ``squared_coverage``).  Every driver calls
    it once per shard and sums the partials in shard order.
    """
    sqx = torch.sum(feats_local * feats_local, dim=-1)
    sqm = torch.sum(medoids * medoids, dim=-1)
    d2 = sqx[:, None] + sqm[None, :] - 2.0 * (feats_local @ medoids.T)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    del d2
    min_dist, assign = torch.min(dist, dim=1)
    counts = torch.bincount(assign, minlength=medoids.shape[0]).to(torch.float32)
    residual = torch.square(min_dist) / 2.0 if squared_coverage else min_dist
    return counts, torch.sum(residual)


def run_tree(
    leaves: Sequence[torch.Tensor],
    bases: Sequence[int],
    fanouts: Sequence[int],
    r_local: int,
    r_node: int,
    r_final: int,
    engine_cfg: EngineConfig,
    squared_coverage: bool,
    wire: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """The one body of every in-process driver: the two rounds (one merge
    level, ``fanouts=(n_shards,)``) and the tree at any depth.

    Leaves select on their devices (``leaf_round``); at each level every
    group of ``fanout`` consecutive nodes ships its candidates through
    ``wire`` (what the receiver sees; None is the fp32 wire) to the group's
    first device — ``all_gather(tiled=True)`` — and re-greedies there
    (``merge_round``, at ``r_final`` on the last level and at most
    ``r_node`` below it); the root's medoids re-weight every leaf, the
    partials summed in leaf order (``psum``).  ``bases[l]`` is leaf l's
    first global row.  Returns (global indices, γ, coverage) on the root's
    device.
    """
    nodes = []  # (cand_feats, cand_w, cand_gidx) per live node, leaf order
    for x, base in zip(leaves, bases):
        idx, w = leaf_round(x, r_local, engine_cfg)
        nodes.append((x[idx], w, base + idx))

    for level, fanout in enumerate(fanouts):
        budget = r_final if level == len(fanouts) - 1 else min(
            r_node, fanout * nodes[0][0].shape[0]
        )
        merged = []
        for lo in range(0, len(nodes), fanout):
            group = nodes[lo:lo + fanout]
            dev = group[0][0].device
            cand_feats = torch.cat([
                (f if wire is None else wire(f)).to(dev) for f, _, _ in group
            ])
            cand_w = torch.cat([w.to(dev) for _, w, _ in group])
            cand_gidx = torch.cat([g.to(dev) for _, _, g in group])
            res = merge_round(cand_feats, cand_w, budget)
            merged.append(
                (cand_feats[res.indices], res.weights, cand_gidx[res.indices])
            )
        nodes = merged
    (root_feats, _, root_gidx), = nodes

    root = root_feats.device
    counts = torch.zeros((r_final,), dtype=torch.float32, device=root)
    coverage = torch.zeros((), dtype=torch.float32, device=root)
    for x in leaves:
        c, cov = reweight(x, root_feats.to(x.device), squared_coverage)
        counts = counts + c.to(root)
        coverage = coverage + cov.to(root)
    return root_gidx, counts, coverage


def local_then_merge(
    shards: Sequence[torch.Tensor],
    r_local: int,
    r_final: int,
    engine_config: EngineConfig | None = None,
    squared_coverage: bool = False,
    local_engine: str | None = None,
    **legacy_knobs,
):
    """The two rounds over explicit shards (the reference's ``shard_map``
    body, run once per shard): the audits and the legacy surface, then
    :func:`run_tree` with one merge level on the fp32 wire.

    Args:
      shards: one (n_local, d) fp32 tensor per shard, in shard order, each
        on its device; all of one size.
      r_local: round-1 budget per shard.
      r_final: final global budget.
      engine_config: typed round-1 config (``ROUND1_ENGINES``); None means
        ``MatrixConfig()``.
      squared_coverage: report L(S) as Σ min ‖x−m‖²/2 (cosine units on a
        unit-normalized pool).
      local_engine / legacy flat knob kwargs: the pre-registry surface,
        shim-mapped with a ``DeprecationWarning``.
    Returns:
      (global_indices (r_final,), weights (r_final,), coverage ()), on the
      first shard's device.
    """
    sizes = {int(s.shape[0]) for s in shards}
    if len(sizes) != 1:
        raise ValueError(f"local_then_merge: shard sizes differ: {sorted(sizes)}")
    n_local = sizes.pop()
    if local_engine is not None or legacy_knobs:
        if engine_config is not None:
            raise TypeError(
                "pass engine_config or the legacy local_engine surface, "
                "not both"
            )
        engine_config = resolve_round1_config(
            # the pre-registry default was the dense matrix round 1
            "matrix" if local_engine is None else local_engine,
            legacy_knobs, n_local, device=shards[0].device,
        )
    ec = engine_config if engine_config is not None else MatrixConfig()
    check_candidate_counts(
        n_local, len(shards), r_local, r_final, where="local_then_merge"
    )

    bases = [s * n_local for s in range(len(shards))]
    return run_tree(
        shards, bases, (len(shards),), r_local, r_final, r_final, ec,
        squared_coverage,
    )


def distributed_select(
    feats,
    mesh,
    r_local: int,
    r_final: int,
    axis_name: str = "data",
    local_engine: str | EngineConfig = "auto",
    squared_coverage: bool = False,
    **legacy_knobs,
) -> DistributedSelection:
    """Two-round distributed selection over ``mesh[axis_name]``.

    ``feats`` is (n, d) with n divisible by the axis size; shard s holds
    rows [s·n/S, (s+1)·n/S) on the mesh's s-th device along the axis.
    ``local_engine`` picks the round-1 body: a typed ``EngineConfig``, or
    ``'auto'`` to resolve it per shard pool size; legacy strings with flat
    knob kwargs warn and map.
    """
    devices = mesh.axis_devices(axis_name)
    n_shards = len(devices)
    n = int(feats.shape[0])
    check_even_shards(n, n_shards, where="distributed_select")
    n_local = n // n_shards
    check_candidate_counts(
        n_local, n_shards, r_local, r_final, where="distributed_select"
    )
    engine_config = resolve_round1_config(
        local_engine, legacy_knobs, n_local, device=devices[0]
    )
    bounds = [(s * n_local, (s + 1) * n_local) for s in range(n_shards)]
    idx, w, cov = local_then_merge(
        shard_rows(feats, bounds, devices), r_local, r_final,
        engine_config=engine_config, squared_coverage=squared_coverage,
    )
    return DistributedSelection(idx, w, cov)


def leaf_bounds(n: int, n_leaves: int) -> list[tuple[int, int]]:
    """Row ranges of an n-row pool over ``n_leaves`` leaves, with
    ``np.array_split`` semantics: the first n mod L leaves hold one more."""
    q, r = divmod(int(n), int(n_leaves))
    edges = [i * q + min(i, r) for i in range(n_leaves + 1)]
    return list(zip(edges[:-1], edges[1:]))
