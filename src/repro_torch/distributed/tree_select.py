"""Hierarchical (tree) distributed selection with a compressed candidate wire.

Port of ``repro.distributed.tree_select``.  Two-round selection
(``core.distributed.local_then_merge``) is the depth-1 case of a
leaf → merge → root tree: leaves select ``r_local`` candidates with any
round-1 engine, every non-leaf node merges its children's candidate sets
with one weighted re-greedy pass (``merge_round``), and the root runs the
final weighted round.  Every gather ships int8 per-row payloads
(``distributed.compression.quantize_rows_int8``, ~4× fewer bytes than
fp32, one-shot so no error feedback); ``compress='none'`` is the fp32
escape hatch.

Three drivers share the same level math (``leaf_round``/``merge_round``),
so their selections agree bit for bit on the same pool; the host and mesh
drivers, and the two rounds, run one body (``core.distributed.run_tree``):

* :func:`tree_select_host` — one process over a global (n, d) pool on one
  device, ragged leaves allowed; the reference driver.
* :func:`tree_select_mesh` — over a level-axis ``Mesh`` (:func:`tree_mesh`),
  each leaf on its mesh device and each merge once per subtree on its
  first device: the single-controller form of the reference's
  ``shard_map`` program; or, one program a rank, over the ``DeviceMesh``
  of ``launch.tree.make_tree_mesh`` (NCCL with one rank per card, gloo on
  the CPU): the levels that span ranks gather over the mesh's groups, the
  rest merge in the rank's process (:func:`split_levels`).
* ``tree_select_processes`` (``distributed.process_tree``) — one process
  per leaf over a ``torch.distributed.TCPStore``.

Each merge level is a GreeDi-style composition; the final exact
re-weighting keeps Σγ = n and the coverage exact over the whole pool at
any depth.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.distributed import (
    check_candidate_counts,
    check_even_shards,
    is_rank_mesh,
    leaf_bounds,
    rank_device,
    rank_index,
    resolve_round1_config,
    run_tree,
    shard_rows,
)
from repro_torch.core.engines import EngineConfig
from repro_torch.distributed.compression import (
    dequantize_rows_int8,
    quantize_rows_int8,
)

__all__ = [
    "WIRE_MODES",
    "TreeTopology",
    "TreeSelectConfig",
    "TreeSelection",
    "tree_mesh",
    "tree_select_host",
    "tree_select_mesh",
    "split_levels",
    "collectives_plan",
    "wire_bytes_plan",
    "default_r_node",
]

WIRE_MODES = ("int8", "none")


def _check_wire(compress: str) -> None:
    if compress not in WIRE_MODES:
        raise ValueError(
            f"compress={compress!r} is not a wire mode; expected one of "
            f"{WIRE_MODES}"
        )


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """A leaf → root merge tree described by per-level fan-outs.

    ``fanouts[0]`` leaves merge into each level-1 node, ``fanouts[1]``
    level-1 nodes into each level-2 node, …, and the last fan-out merges
    into the root.  ``n_leaves = Π fanouts``; ``depth = len(fanouts)``
    merge levels; ``fanouts=(n_shards,)`` is the two-round path.
    """

    fanouts: tuple[int, ...]

    def __post_init__(self):
        fo = tuple(int(f) for f in self.fanouts)
        object.__setattr__(self, "fanouts", fo)
        if not fo:
            raise ValueError("TreeTopology needs at least one fan-out level")
        if any(f < 1 for f in fo):
            raise ValueError(f"fan-outs must be ≥ 1, got {fo}")
        if all(f == 1 for f in fo):
            raise ValueError(
                f"degenerate topology {fo}: at least one fan-out must be "
                "> 1 (a chain of 1-child merges re-greedies the same "
                "candidate set over and over)"
            )

    @property
    def depth(self) -> int:
        """Number of merge levels (leaves excluded)."""
        return len(self.fanouts)

    @property
    def n_leaves(self) -> int:
        n = 1
        for f in self.fanouts:
            n *= f
        return n

    def nodes_at(self, level: int) -> int:
        """Node count after ``level`` merges (level 0 = leaves)."""
        n = self.n_leaves
        for f in self.fanouts[:level]:
            n //= f
        return n

    @property
    def axis_names(self) -> tuple[str, ...]:
        """Mesh axis per merge level, leaf-adjacent first."""
        return tuple(f"lvl{i}" for i in range(self.depth))

    def to_dict(self) -> dict:
        return {"fanouts": list(self.fanouts)}

    @classmethod
    def from_dict(cls, d: dict) -> "TreeTopology":
        return cls(fanouts=tuple(d["fanouts"]))


@dataclasses.dataclass(frozen=True)
class TreeSelectConfig(EngineConfig):
    """Provenance record of a tree-orchestrated selection.

    Not a registered ``SelectionEngine`` — the tree orchestrates the
    round-1 engines — but it speaks the ``EngineConfig`` dict protocol, and
    ``engine_config_from_dict`` dispatches ``name == 'tree'`` here.

    Attributes:
      fanouts: the merge-tree shape (``TreeTopology.fanouts``).
      compress: candidate wire mode, ``'int8'`` or ``'none'``.
      local: the resolved leaf engine's ``EngineConfig.to_dict()``.
      degraded: the process driver finished under quorum degradation.
      missing_pids: the dead leaves' process indices.
      quorum: surviving-leaf fraction (1.0 when clean).
    """

    name: ClassVar[str] = "tree"
    fanouts: tuple[int, ...] = (2,)
    compress: str = "int8"
    local: dict | None = None
    degraded: bool = False
    missing_pids: tuple[int, ...] = ()
    quorum: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "fanouts", tuple(int(f) for f in self.fanouts))
        object.__setattr__(
            self, "missing_pids", tuple(int(p) for p in self.missing_pids)
        )
        _check_wire(self.compress)

    @property
    def topology(self) -> TreeTopology:
        return TreeTopology(self.fanouts)


# ---------------------------------------------------------------------------
# Candidate wire
# ---------------------------------------------------------------------------


def _through_wire(feats: torch.Tensor, compress: str) -> torch.Tensor:
    """What the receiving merge node sees of a shipped candidate matrix."""
    _check_wire(compress)
    if compress == "int8":
        return dequantize_rows_int8(*quantize_rows_int8(feats))
    return feats


def _wire(compress: str):
    """``run_tree``'s wire for a mode: None (fp32 as is) or the int8
    ``(encode, decode)`` pair, quantized by the sender."""
    _check_wire(compress)
    return None if compress == "none" else (quantize_rows_int8, dequantize_rows_int8)


def _payload_bytes(r: int, d: int, compress: str) -> int:
    """Wire bytes of one (r, d) candidate-feature payload."""
    if compress == "int8":
        return r * d + 4 * r  # int8 payload + fp32 per-row scales
    return 4 * r * d


def wire_bytes_plan(
    topology: TreeTopology,
    r_local: int,
    r_node: int,
    d: int,
    compress: str,
) -> dict:
    """Bytes-on-wire accounting of one tree selection.

    Counts the candidate-feature payloads every non-leaf gather ships (the
    γ and global-id sidecars are the same in both modes and excluded; the
    int8 mode's fp32 scales are included).  Per level every child node
    ships its candidate matrix once.
    """
    _check_wire(compress)
    per_level = []
    r = r_local
    for level, fanout in enumerate(topology.fanouts):
        n_children = topology.nodes_at(level)
        per_level.append(
            {
                "level": level + 1,
                "children": n_children,
                "r_child": r,
                "bytes": n_children * _payload_bytes(r, d, compress),
                "fp32_bytes": n_children * _payload_bytes(r, d, "none"),
            }
        )
        r = min(r_node, fanout * r)  # what each merged node forwards
    total = sum(lv["bytes"] for lv in per_level)
    fp32_total = sum(lv["fp32_bytes"] for lv in per_level)
    return {
        "compress": compress,
        "per_level": per_level,
        "gathered_feature_bytes": total,
        "fp32_feature_bytes": fp32_total,
        "reduction": fp32_total / max(total, 1),
    }


def default_r_node(r_local: int, r_final: int) -> int:
    """Intermediate merge budget: every non-root node forwards this many,
    ``max(r_local, r_final)`` — at least the final budget's worth of
    candidates survives every level."""
    return max(int(r_local), int(r_final))


class TreeSelection(NamedTuple):
    """Result of a hierarchical selection (same contract at any depth).

    Attributes:
      indices: (r_final,) int64 — global pool indices.
      weights: (r_final,) float32 — exact global γ, Σ == n.
      coverage: () float32 — exact global L(S).
      wire: bytes-on-wire accounting (:func:`wire_bytes_plan`).
      health: the process driver's degradation record (``degraded``,
        ``missing_pids``, ``quorum``, ``min_quorum``, ``r_final``,
        ``level_deadline_s``); None from the host and mesh drivers.

    Over a ``DeviceMesh`` every rank returns the same selection, on its
    own device.
    """

    indices: torch.Tensor
    weights: torch.Tensor
    coverage: torch.Tensor
    wire: dict
    health: dict | None = None


def _check_tree_counts(
    leaf_sizes: list[int],
    topology: TreeTopology,
    r_local: int,
    r_node: int,
    r_final: int,
    *,
    where: str,
) -> None:
    """Candidate-count invariants at every level of the tree."""
    if r_node < 1:
        raise ValueError(f"{where}: r_node={r_node} must be ≥ 1")
    depth = topology.depth
    level1_budget = r_final if depth == 1 else min(
        r_node, topology.fanouts[0] * r_local
    )
    check_candidate_counts(
        min(leaf_sizes), topology.fanouts[0], r_local, level1_budget,
        where=f"{where} (level 1)",
    )
    r = r_local
    for level, fanout in enumerate(topology.fanouts):
        budget = r_final if level == depth - 1 else min(r_node, fanout * r)
        if fanout * r < budget:
            raise ValueError(
                f"{where}: level {level + 1} merges only {fanout}×{r}="
                f"{fanout * r} candidates, fewer than its budget "
                f"{budget} — raise r_local/r_node or lower r_final"
            )
        r = budget


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def tree_select_host(
    feats,
    topology: TreeTopology,
    r_local: int,
    r_final: int,
    *,
    r_node: int | None = None,
    local_engine: str | EngineConfig = "auto",
    compress: str = "int8",
    squared_coverage: bool = False,
) -> TreeSelection:
    """Single-process hierarchical selection over a global (n, d) pool.

    The pool splits into ``topology.n_leaves`` contiguous leaf shards
    (ragged splits allowed, ``np.array_split`` semantics), each leaf runs
    ``leaf_round`` with the resolved engine, and candidate sets merge up
    the tree with every non-leaf gather through the ``compress`` wire.
    The final re-weighting assigns every pool point to its nearest final
    medoid, so ``weights`` and ``coverage`` are exact at any depth.
    Everything runs on ``feats``' device (numpy input: the CPU).
    """
    _check_wire(compress)
    feats = torch.as_tensor(feats, dtype=torch.float32)
    n, d = feats.shape
    n_leaves = topology.n_leaves
    if n_leaves > n:
        raise ValueError(
            f"tree_select_host: topology has {n_leaves} leaves but the "
            f"pool only has {n} points"
        )
    r_node = default_r_node(r_local, r_final) if r_node is None else int(r_node)
    bounds = leaf_bounds(n, n_leaves)
    sizes = [hi - lo for lo, hi in bounds]
    _check_tree_counts(
        sizes, topology, r_local, r_node, r_final, where="tree_select_host",
    )
    engine_cfg = resolve_round1_config(
        local_engine, {}, min(sizes), device=feats.device
    )
    leaves = shard_rows(feats, bounds, [feats.device] * n_leaves)
    idx, w, cov = run_tree(
        leaves, [lo for lo, _ in bounds], topology.fanouts, r_local, r_node,
        r_final, engine_cfg, squared_coverage, _wire(compress),
    )
    wire = wire_bytes_plan(topology, r_local, r_node, d, compress)
    return TreeSelection(idx, w, cov, wire)


# ---------------------------------------------------------------------------
# Mesh driver
# ---------------------------------------------------------------------------


def tree_mesh(topology: TreeTopology, devices=None):
    """Mesh with one axis per merge level: shape ``reversed(fanouts)``,
    axes ``('lvl{L-1}', …, 'lvl0')`` — ``lvl0`` minor, so sibling leaves
    are neighbours.  Takes exactly ``n_leaves`` device entries (a device
    may repeat); ``devices=None`` deals the leaves over the visible cards
    in order (``launch.mesh.compat_mesh``; raises without a card)."""
    from repro_torch.launch.mesh import Mesh, compat_mesh

    if devices is None:
        return compat_mesh(
            tuple(reversed(topology.fanouts)),
            tuple(reversed(topology.axis_names)),
        )
    if len(devices) != topology.n_leaves:
        raise ValueError(
            f"tree_mesh: topology has {topology.n_leaves} leaves but "
            f"{len(devices)} devices were given — fan-outs must multiply "
            "to the device count"
        )
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(
        arr.reshape(tuple(reversed(topology.fanouts))),
        tuple(reversed(topology.axis_names)),
    )


def split_levels(fanouts: Sequence[int], world: int) -> tuple[int, tuple[str, ...]]:
    """How a tree of ``fanouts`` lies over ``world`` ranks: ``(k, axes)``.

    k is the smallest level whose fan-outs k … L−1 multiply to ``world``:
    those levels span ranks, ``axes`` their level axes major first
    (``('lvl{L-1}', …, 'lvl{k}')``), and levels 0 … k−1 are each rank's
    own Π fanouts[:k] leaves, merged in its process (``lvl0`` minor, as on
    the single-controller mesh).  Leaf ids stay row-major over
    ``(lvl{L-1}, …, lvl0)``, so rank r owns leaves [r·Π fanouts[:k],
    (r+1)·Π fanouts[:k]).

    Raises:
      ValueError: no such k, or k = L (a group of one rank under a root
        fan-out > 1: no level would span it).
    """
    topology = TreeTopology(tuple(fanouts))
    fo = topology.fanouts
    for k in range(len(fo) + 1):
        if math.prod(fo[k:]) == world:
            break
    else:
        raise ValueError(
            f"fan-outs {fo} do not lie over {world} ranks: no trailing run of "
            f"them multiplies to the world size {world}"
        )
    if k == len(fo):
        raise ValueError(
            f"fan-outs {fo} over {world} rank leave no level spanning the "
            "ranks; end them with a fan-out of 1 (e.g. "
            f"{fo + (1,)}) for a root level over the group"
        )
    return k, tuple(reversed(topology.axis_names[k:]))


def collectives_plan(rank_levels: int, compress: str) -> int:
    """The collectives one rank calls in :func:`tree_select_mesh` over a
    ``DeviceMesh`` of ``rank_levels`` level axes: at each, the candidate
    payload (int8 codes and fp32 row scales, or fp32 rows), γ and the
    global ids; then one gather a level axis of the re-weighting's
    partials."""
    _check_wire(compress)
    payload = 2 if compress == "int8" else 1
    return rank_levels * (payload + 2 + 1)


def _rank_levels(mesh, topology: TreeTopology) -> int:
    """k of a ``DeviceMesh`` over the topology's top levels: its axes and
    shape must be those :func:`split_levels` gives its size."""
    k, axes = split_levels(topology.fanouts, mesh.size())
    shape = tuple(reversed(topology.fanouts[k:]))
    if tuple(mesh.mesh_dim_names or ()) != axes or tuple(mesh.mesh.shape) != shape:
        raise ValueError(
            f"tree_select_mesh: a DeviceMesh of axes {mesh.mesh_dim_names} and "
            f"shape {tuple(mesh.mesh.shape)} is not the top levels {axes} {shape} of "
            f"fan-outs {topology.fanouts} — build it with "
            "launch.tree.make_tree_mesh(fanouts)"
        )
    return k


def tree_select_mesh(
    feats,
    mesh,
    topology: TreeTopology,
    r_local: int,
    r_final: int,
    *,
    r_node: int | None = None,
    local_engine: str | EngineConfig = "auto",
    compress: str = "int8",
    squared_coverage: bool = False,
) -> TreeSelection:
    """Hierarchical selection over a level-axis ``mesh``.

    ``feats`` is the global (n, d) pool, n divisible by ``n_leaves``; leaf
    l (row-major over ``(lvl{L-1}, …, lvl0)``) holds rows
    [l·n/L, (l+1)·n/L).  ``mesh`` is either

    * a ``launch.mesh.Mesh`` carrying every level axis (:func:`tree_mesh`):
      each leaf on its mesh device, each merge once, on the first device
      of its subtree, where the reference replicates it over the subtree;
    * or a ``DeviceMesh`` over the top levels (``launch.tree.make_tree_mesh``,
      :func:`split_levels`), every rank calling this with the same
      ``feats``: a rank selects its own leaves on its device, merges the
      local levels in its process and gathers each rank level over the
      mesh's group of that axis, the merge replicated on every rank of the
      subtree as in the reference; the re-weighting's partials are
      gathered and summed in leaf order (:func:`collectives_plan` counts
      the collectives).  Every rank returns the same selection.

    Equal to :func:`tree_select_host` bit for bit when the devices are of
    one kind.
    """
    _check_wire(compress)
    rank_mesh = is_rank_mesh(mesh)
    if rank_mesh:
        k = _rank_levels(mesh, topology)
    else:
        for ax in topology.axis_names:
            if ax not in mesh.shape:
                raise ValueError(
                    f"tree_select_mesh: mesh axes {tuple(mesh.shape)} are "
                    f"missing level axis {ax!r} — build the mesh with "
                    "tree_mesh(topology)"
                )
    n, d = feats.shape
    n_leaves = topology.n_leaves
    check_even_shards(n, n_leaves, where="tree_select_mesh")
    n_local = n // n_leaves
    r_node = default_r_node(r_local, r_final) if r_node is None else int(r_node)
    _check_tree_counts(
        [n_local], topology, r_local, r_node, r_final, where="tree_select_mesh",
    )
    groups = ()
    if rank_mesh:
        per_rank = math.prod(topology.fanouts[:k])
        first = rank_index(mesh) * per_rank
        devices = [rank_device(mesh)] * per_rank
        groups = [mesh.get_group(ax) for ax in topology.axis_names[k:]]
    else:
        # leaf order is row-major over (lvl{L-1}, …, lvl0), as the
        # reference's leaf id from the axis coordinates
        order = tuple(reversed(topology.axis_names))
        devices = list(mesh.devices.transpose(
            [mesh.axis_names.index(ax) for ax in order]).reshape(-1))
        first = 0
    engine_cfg = resolve_round1_config(local_engine, {}, n_local, device=devices[0])
    bounds = [((first + i) * n_local, (first + i + 1) * n_local)
              for i in range(len(devices))]
    idx, w, cov = run_tree(
        shard_rows(feats, bounds, devices), [lo for lo, _ in bounds],
        topology.fanouts, r_local, r_node, r_final, engine_cfg,
        squared_coverage, _wire(compress), groups,
    )
    wire = wire_bytes_plan(topology, r_local, r_node, d, compress)
    return TreeSelection(idx, w, cov, wire)
