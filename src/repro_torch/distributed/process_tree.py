"""Process-spanning tree selection over a ``torch.distributed.TCPStore``.

Port of ``repro.distributed.process_tree``.  One *process* per leaf runs
the tree of ``distributed.tree_select``; the wire is a key-value store —
a ``TCPStore`` hosted by process 0 (``launch.tree.initialize_distributed``)
in place of the reference's ``jax.distributed`` coordination service.  No
process group and no NCCL are needed: the store is the wire.

* every live node at a level serializes its candidate payload (int8 rows
  plus fp32 per-row scales, or raw fp32 under ``compress='none'``) into
  the store;
* each parent *owner* (the lowest pid under the parent) waits for its
  children's keys, dequantizes, and runs the same ``merge_round``;
* the root owner publishes the final medoids (exact fp32, so every
  process re-weights against bit-identical medoids);
* re-weighting partials are combined in pid order, as the host driver
  accumulates in leaf order.

With every process alive the selection equals ``tree_select_host`` on the
concatenated pool bit for bit (indices, weights and coverage), because
every payload — a merge owner's own included — passes through the same
wire codec in the same leaf order.

Fault model.  Every process bumps a heartbeat counter on a background
thread (with a store connection of its own: a blocking wait holds a
connection); every wait on another process's key is bounded by a
per-level deadline (``HealthConfig.level_deadline_s``, defaulting to
``$REPRO_KV_TIMEOUT_MS``) and watched against the publisher's heartbeat.
When a child subtree misses its deadline or its owner goes silent, the
parent owner proceeds without it — provided the surviving leaves meet
``HealthConfig.min_quorum`` — and records the loss in a dead-leaf mask
that composes up the tree (payload first, mask last, so a mask's arrival
guarantees its payload).  The root's mask is authoritative: excluded but
live processes raise :class:`ShardExcludedError`, and the returned
``TreeSelection`` carries a ``health`` record with Σγ over the *surviving*
shards.  A dead merge owner loses its whole subtree; the root owner
(pid 0, which also hosts the store) and a process dying after the root
broadcast are single points of failure, surfacing as
:class:`KVStoreError` after the deadline.

Wire primitives: a polled cell is a string value read with a
non-blocking ``check`` then ``get``; bulk payloads are read only by
:func:`_raw_get_bytes` (``wait([key], timeout)`` then ``get``), after
their commit record has arrived.  Keys are namespaced by a per-call tag
whose default comes from a module-level counter, so all processes must
make the same sequence of calls (the SPMD contract).
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import threading
import time

import numpy as np
import torch

from repro_torch.core.distributed import leaf_round, merge_round, resolve_round1_config, reweight
from repro_torch.core.engines import EngineConfig
from repro_torch.distributed.compression import (
    dequantize_rows_int8,
    quantize_rows_int8,
)
from repro_torch.distributed.tree_select import (
    WIRE_MODES,
    TreeSelection,
    TreeTopology,
    _check_tree_counts,
    default_r_node,
    wire_bytes_plan,
)
from repro_torch.faults import fault_point

__all__ = [
    "tree_select_processes",
    "kv_timeout_ms",
    "HealthConfig",
    "KVStoreError",
    "QuorumError",
    "ShardExcludedError",
    "KV_TIMEOUT_ENV",
]

_CALLS = itertools.count()

KV_TIMEOUT_ENV = "REPRO_KV_TIMEOUT_MS"
_DEFAULT_TIMEOUT_MS = 300_000


def kv_timeout_ms() -> int:
    """Default store-get timeout in ms: ``$REPRO_KV_TIMEOUT_MS``, else
    300 s; also the default per-level deadline of :class:`HealthConfig`."""
    raw = os.environ.get(KV_TIMEOUT_ENV)
    if raw is None:
        return _DEFAULT_TIMEOUT_MS
    try:
        ms = int(raw)
    except ValueError as e:
        raise ValueError(
            f"${KV_TIMEOUT_ENV}={raw!r} is not an integer millisecond count"
        ) from e
    if ms <= 0:
        raise ValueError(f"${KV_TIMEOUT_ENV}={ms} must be > 0")
    return ms


class KVStoreError(RuntimeError):
    """A store get failed terminally (missing key, or a dead peer past the
    point of graceful degradation); names the key, pid and tree level."""


class QuorumError(RuntimeError):
    """Too few surviving leaves to proceed (below ``min_quorum``)."""


class ShardExcludedError(RuntimeError):
    """This process was excluded from the selection (its subtree's owner
    died before publishing), so its shard is not in the survivors' result."""


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Liveness and degradation knobs of :func:`tree_select_processes`.

    Attributes:
      level_deadline_s: how long a parent owner waits for one child
        subtree before declaring it dead (None → ``$REPRO_KV_TIMEOUT_MS``,
        itself 300 s by default).
      heartbeat_interval_s: heartbeat period.
      heartbeat_grace_s: silence longer than this marks a peer dead (≥ 2×
        the interval).
      poll_ms: poll period while waiting under a deadline.
      min_quorum: minimum surviving-leaf fraction per merge group; below it
        the selection fails with :class:`QuorumError` (1.0 = any death is
        fatal, within the deadline).
    """

    level_deadline_s: float | None = None
    heartbeat_interval_s: float = 0.5
    heartbeat_grace_s: float = 5.0
    poll_ms: int = 100
    min_quorum: float = 1.0

    def __post_init__(self):
        if self.level_deadline_s is not None and self.level_deadline_s <= 0:
            raise ValueError(
                f"level_deadline_s={self.level_deadline_s} must be > 0"
            )
        if self.heartbeat_interval_s <= 0:
            raise ValueError(
                f"heartbeat_interval_s={self.heartbeat_interval_s} must be > 0"
            )
        if self.heartbeat_grace_s < 2 * self.heartbeat_interval_s:
            raise ValueError(
                f"heartbeat_grace_s={self.heartbeat_grace_s} must be ≥ 2× "
                f"heartbeat_interval_s={self.heartbeat_interval_s} or every "
                "scheduling hiccup reads as a death"
            )
        if int(self.poll_ms) < 1:
            raise ValueError(f"poll_ms={self.poll_ms} must be ≥ 1")
        if not 0.0 < self.min_quorum <= 1.0:
            raise ValueError(
                f"min_quorum={self.min_quorum} must be in (0, 1]"
            )

    def deadline_s(self) -> float:
        return (
            kv_timeout_ms() / 1000.0
            if self.level_deadline_s is None
            else float(self.level_deadline_s)
        )


# ---------------------------------------------------------------------------
# Store wire primitives
# ---------------------------------------------------------------------------


def _raw_get_bytes(store, key: str, timeout_ms: int) -> bytes:
    """The one blocking getter: wait for ``key`` up to ``timeout_ms``."""
    store.wait([key], datetime.timedelta(milliseconds=int(timeout_ms)))
    return store.get(key)


def _put_cell(store, key: str, value: str) -> None:
    """Publish a polled cell: a UTF-8 string value at ``key``."""
    store.set(key, str(value))


def _poll_str(store, key: str) -> str | None:
    """Non-blocking read of the polled cell at ``key``: its value, or None
    if absent.  A store error reads as absent — the deadline decides when
    absence becomes an error."""
    try:
        fault_point("kv.get", key=key)
        if not store.check([key]):
            return None
        return store.get(key).decode()
    except RuntimeError:  # FaultInjected, DistStoreError: absence, by contract
        return None


def _encode_mask(mask: np.ndarray) -> str:
    return "".join("1" if x else "0" for x in mask)


def _decode_mask(s: str) -> np.ndarray:
    return np.array([c == "1" for c in s], np.int8)


def _kv_get(
    store,
    key: str,
    shape,
    dtype,
    *,
    pid: int,
    level,
    what: str,
    timeout_ms: int | None = None,
) -> np.ndarray:
    """Blocking get with a deadline and a contextual error: any failure
    (timeout, dropped key, transport) surfaces as a :class:`KVStoreError`
    naming the key, the waiting pid and the tree level."""
    timeout_ms = kv_timeout_ms() if timeout_ms is None else int(timeout_ms)
    try:
        fault_point("kv.get", key=key, pid=pid, level=level)
        raw = _raw_get_bytes(store, key, timeout_ms)
    except RuntimeError as e:  # FaultInjected, DistStoreError, DistNetworkError
        raise KVStoreError(
            f"KV get of key {key!r} ({what}) failed in pid {pid} at tree "
            f"level {level} after {timeout_ms} ms: {type(e).__name__}: {e}"
        ) from e
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


class _Heartbeat:
    """Bumps the counter ``{tag}/hb/{pid}`` every interval on a daemon
    thread, through a store connection of its own."""

    def __init__(self, store, tag: str, pid: int, interval_s: float):
        self._store = store
        self._key = f"{tag}/hb/{pid}"
        self._interval_s = float(interval_s)
        self._stop = threading.Event()
        self.error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name=f"tree-heartbeat-{pid}", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._store.add(self._key, 1)
                self._stop.wait(self._interval_s)
        except RuntimeError as e:  # surfaced via .error; peers see silence
            self.error = e

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class _HeartbeatMonitor:
    """Watches one peer's heartbeat counter; ``alive()`` is False once the
    peer has been silent longer than the grace window."""

    def __init__(self, store, tag: str, pid: int, grace_s: float):
        self._store = store
        self._key = f"{tag}/hb/{pid}"
        self._grace_s = float(grace_s)
        self._n_beats = 0
        self._last_seen = time.monotonic()  # creation counts as a beat

    def alive(self) -> bool:
        try:
            n = int(self._store.add(self._key, 0))  # read without a bump
        except RuntimeError:  # a transient store failure
            n = self._n_beats
        if n > self._n_beats:
            self._n_beats = n
            self._last_seen = time.monotonic()
        return time.monotonic() - self._last_seen < self._grace_s


def _await_key(
    store,
    key: str,
    *,
    deadline_s: float,
    poll_ms: int,
    monitor: _HeartbeatMonitor | None = None,
) -> str | None:
    """Wait for the polled cell at ``key`` under a deadline, watching its
    publisher's heartbeat.  Returns the value, or None when the deadline
    expires or the publisher dies first.  A dead publisher gets one final
    probe — publish-then-die is a committed publish."""
    deadline = time.monotonic() + float(deadline_s)
    poll_s = max(1, int(poll_ms)) / 1000.0
    while True:
        val = _poll_str(store, key)
        if val is not None:
            return val
        now = time.monotonic()
        if now >= deadline:
            return None
        if monitor is not None and not monitor.alive():
            return _poll_str(store, key)
        time.sleep(min(poll_s, deadline - now))


# ---------------------------------------------------------------------------
# Degraded candidate counts
# ---------------------------------------------------------------------------


def _nominal_r(
    level: int, topology: TreeTopology, r_local: int, r_node: int, r_final: int
) -> int:
    """Candidate count a node holds after ``level`` merges, clean tree."""
    if level == 0:
        return int(r_local)
    fanout = topology.fanouts[level - 1]
    below = _nominal_r(level - 1, topology, r_local, r_node, r_final)
    if level == topology.depth:
        return int(r_final)
    return min(int(r_node), fanout * below)


def _node_r(
    level: int,
    node: int,
    dead: np.ndarray,
    topology: TreeTopology,
    r_local: int,
    r_node: int,
    r_final: int,
) -> int:
    """Candidate count of node ``node`` after ``level`` merges given the
    dead-leaf mask: :func:`_nominal_r` when its subtree is clean,
    ``min(budget, surviving union)`` otherwise, 0 when all of it is dead.
    Both sides of every wire derive payload shapes from this."""
    if level == 0:
        return 0 if dead[node] else int(r_local)
    fanout = topology.fanouts[level - 1]
    union = sum(
        _node_r(
            level - 1, node * fanout + c, dead, topology,
            r_local, r_node, r_final,
        )
        for c in range(fanout)
    )
    if union == 0:
        return 0
    return min(
        _nominal_r(level, topology, r_local, r_node, r_final), union
    )


def _require_quorum(
    alive_leaves: int,
    total_leaves: int,
    min_quorum: float,
    *,
    level,
    node: int,
    missing: list[int],
) -> None:
    if alive_leaves / max(total_leaves, 1) < min_quorum - 1e-9:
        raise QuorumError(
            f"tree_select_processes: merge level {level} node {node} has "
            f"only {alive_leaves}/{total_leaves} surviving leaves, below "
            f"min_quorum={min_quorum} (dead pids: {sorted(missing)})"
        )


# ---------------------------------------------------------------------------
# Wire payloads
# ---------------------------------------------------------------------------


def _put(store, key: str, arr) -> None:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    store.set(key, np.ascontiguousarray(arr).tobytes())


def _put_payload(store, key, feats, w, gidx, compress):
    if compress == "int8":
        q, s = quantize_rows_int8(feats)
        _put(store, key + "/q", q)
        _put(store, key + "/s", s)
    else:
        _put(store, key + "/f", feats.float())
    _put(store, key + "/w", w.float())
    _put(store, key + "/g", gidx.to(torch.int64))


def _get_payload(store, key, r, d, compress, device, *, pid, level, timeout_ms=None):
    kw = dict(pid=pid, level=level, timeout_ms=timeout_ms)

    def get(suffix, shape, dtype, what):
        arr = _kv_get(store, key + suffix, shape, dtype, what=what, **kw)
        return torch.from_numpy(arr).to(device)

    if compress == "int8":
        feats = dequantize_rows_int8(
            get("/q", (r, d), np.int8, "candidate int8 payload"),
            get("/s", (r,), np.float32, "candidate scales"),
        )
    else:
        feats = get("/f", (r, d), np.float32, "candidate fp32 payload")
    w = get("/w", (r,), np.float32, "candidate weights")
    gidx = get("/g", (r,), np.int64, "candidate global ids")
    return feats, w, gidx


def _second_connection(store):
    """A second client of ``store``'s server for the heartbeat thread."""
    return torch.distributed.TCPStore(
        store.host, store.port, is_master=False, timeout=store.timeout
    )


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def tree_select_processes(
    feats_local,
    topology: TreeTopology,
    r_local: int,
    r_final: int,
    *,
    store,
    pid: int,
    nproc: int,
    r_node: int | None = None,
    local_engine: str | EngineConfig = "auto",
    compress: str = "int8",
    squared_coverage: bool = False,
    tag: str | None = None,
    health: HealthConfig | None = None,
) -> TreeSelection:
    """Hierarchical selection with one process per leaf.

    SPMD: every process calls with its own ``(n_pid, d)`` shard (ragged
    sizes allowed; the shard's device is where this process computes),
    the shared ``store`` (a ``TCPStore``), its ``pid`` and the process
    count ``nproc``.  Returns the replicated ``TreeSelection`` in every
    surviving process, with global indices into the pid-order
    concatenation of the *surviving* shards; ``health`` records any quorum
    degradation (module docstring).
    """
    if compress not in WIRE_MODES:
        raise ValueError(
            f"compress={compress!r} is not a wire mode; expected one of "
            f"{WIRE_MODES}"
        )
    health = HealthConfig() if health is None else health
    if nproc != topology.n_leaves:
        raise ValueError(
            f"tree_select_processes: topology has {topology.n_leaves} "
            f"leaves but {nproc} processes are running — one process per "
            "leaf"
        )
    tag = f"tree/{next(_CALLS)}" if tag is None else f"tree/{tag}"
    feats_local = torch.as_tensor(feats_local, dtype=torch.float32)
    dev = feats_local.device
    n_local, d = feats_local.shape
    r_node = default_r_node(r_local, r_final) if r_node is None else int(r_node)
    deadline_s = health.deadline_s()
    poll_ms = int(health.poll_ms)
    deadline_ms = int(deadline_s * 1000)

    hb = _Heartbeat(_second_connection(store), tag, pid, health.heartbeat_interval_s)
    try:
        monitors = {
            p: _HeartbeatMonitor(store, tag, p, health.heartbeat_grace_s)
            for p in range(nproc)
            if p != pid
        }

        # -- size exchange, root-arbitrated -------------------------------
        # pid 0 gathers every shard size (a leaf missing its deadline is
        # declared dead up front) and publishes one canonical size vector,
        # so every survivor agrees on the leaf-level dead set and on the
        # global index bases.
        _put_cell(store, f"{tag}/n/{pid}", str(n_local))
        if pid == 0:
            sizes = np.empty((nproc,), np.int64)
            sizes[0] = n_local
            for p in range(1, nproc):
                raw = _await_key(
                    store, f"{tag}/n/{p}",
                    deadline_s=deadline_s, poll_ms=poll_ms,
                    monitor=monitors[p],
                )
                sizes[p] = -1 if raw is None else int(raw)
            _put_cell(store, f"{tag}/sizes", ",".join(str(int(s)) for s in sizes))
        else:
            # 2× the level deadline per peer: covers pid 0's full gather
            raw = _await_key(
                store, f"{tag}/sizes",
                deadline_s=2 * deadline_s * max(1, nproc - 1),
                poll_ms=poll_ms, monitor=monitors[0],
            )
            if raw is None:
                raise KVStoreError(
                    f"KV get of key {tag + '/sizes'!r} (canonical shard "
                    f"sizes) failed in pid {pid} at tree level 0: the root "
                    "arbiter (pid 0) never published — pid 0 death is "
                    "fatal by design"
                )
            sizes = np.array([int(x) for x in raw.split(",")], np.int64)
        dead = np.zeros((nproc,), np.int8)
        dead[sizes < 0] = 1
        missing = [int(p) for p in np.nonzero(dead)[0]]
        if dead[pid]:  # declared dead but alive: a straggler
            raise ShardExcludedError(
                f"pid {pid} missed the size-exchange deadline "
                f"({deadline_s:.1f} s) and was excluded from the selection"
            )
        _require_quorum(
            nproc - len(missing), nproc, health.min_quorum,
            level=0, node=0, missing=missing,
        )
        alive_sizes = [int(s) for s in sizes if s >= 0]
        _check_tree_counts(
            alive_sizes, topology, r_local, r_node, r_final,
            where="tree_select_processes",
        )
        # global index base over the surviving shards in pid order
        base = int(sum(s for s in sizes[:pid] if s >= 0))
        engine_cfg = resolve_round1_config(
            local_engine, {}, min(alive_sizes), device=dev
        )

        local_idx, local_w = leaf_round(feats_local, r_local, engine_cfg)
        cand_feats = feats_local[local_idx]
        cand_w = local_w
        cand_gidx = base + local_idx

        nr = dict(
            topology=topology, r_local=r_local, r_node=r_node, r_final=r_final
        )

        # -- merge levels -------------------------------------------------
        # Live node owners publish the payload, then their dead mask: the
        # mask is the commit record.
        stride = 1
        for level, fanout in enumerate(topology.fanouts):
            if pid % stride == 0 and not dead[pid]:
                node = pid // stride
                key = f"{tag}/l{level}/{node}"
                fault_point("tree.publish", pid=pid, level=level)
                _put_payload(store, key, cand_feats, cand_w, cand_gidx, compress)
                _put_cell(store, key + "/dead", _encode_mask(dead))
            parent_stride = stride * fanout
            if pid % parent_stride == 0:
                first_child = pid // stride
                feats_l, w_l, gidx_l = [], [], []
                for c in range(first_child, first_child + fanout):
                    child_owner = c * stride
                    sub = slice(child_owner, child_owner + stride)
                    if c == first_child:
                        child_mask = dead.copy()  # our own subtree: local view
                    elif dead[sub].all():
                        continue  # known dead since the size exchange
                    else:
                        raw = _await_key(
                            store, f"{tag}/l{level}/{c}/dead",
                            deadline_s=deadline_s, poll_ms=poll_ms,
                            monitor=monitors.get(child_owner),
                        )
                        if raw is None:
                            # a dead owner loses its whole subtree
                            dead[sub] = 1
                            continue
                        child_mask = _decode_mask(raw)
                        dead = np.maximum(dead, child_mask)
                    child_r = _node_r(level, c, child_mask, **nr)
                    if child_r == 0:
                        continue
                    f, w, g = _get_payload(
                        store, f"{tag}/l{level}/{c}", child_r, d, compress, dev,
                        pid=pid, level=level + 1, timeout_ms=deadline_ms,
                    )
                    feats_l.append(f)
                    w_l.append(w)
                    gidx_l.append(g)
                missing = [int(p) for p in np.nonzero(dead)[0]]
                group = slice(first_child * stride, (first_child + fanout) * stride)
                group_leaves = group.stop - group.start
                _require_quorum(
                    group_leaves - int(dead[group].sum()), group_leaves,
                    health.min_quorum,
                    level=level + 1, node=pid // parent_stride,
                    missing=missing,
                )
                union_feats = torch.cat(feats_l)
                union_w = torch.cat(w_l)
                union_gidx = torch.cat(gidx_l)
                nominal = _nominal_r(level + 1, topology, r_local, r_node, r_final)
                budget = min(nominal, int(union_feats.shape[0]))
                keep = merge_round(union_feats, union_w, budget)
                cand_feats = union_feats[keep.indices]
                cand_w = keep.weights
                cand_gidx = union_gidx[keep.indices]
            stride = parent_stride

        # -- root broadcast ----------------------------------------------
        # Medoids first, the authoritative final dead mask last.
        if pid == 0:
            fault_point("tree.publish", pid=pid, level=topology.depth)
            _put(store, f"{tag}/final/f", cand_feats.float())
            _put(store, f"{tag}/final/g", cand_gidx.to(torch.int64))
            _put_cell(store, f"{tag}/final/dead", _encode_mask(dead))
            root_mask = dead
        else:
            raw = _await_key(
                store, f"{tag}/final/dead",
                # pid 0 must finish every merge level first
                deadline_s=deadline_s * (topology.depth + 1),
                poll_ms=poll_ms, monitor=monitors[0],
            )
            if raw is None:
                raise KVStoreError(
                    f"KV get of key {tag + '/final/dead'!r} (final dead "
                    f"mask) failed in pid {pid} at tree level "
                    f"{topology.depth}: the root owner (pid 0) never "
                    "published — pid 0 death is fatal by design"
                )
            root_mask = _decode_mask(raw)
        if root_mask[pid]:
            raise ShardExcludedError(
                f"pid {pid} was excluded from the selection (its subtree's "
                "owner died before publishing its candidates); this "
                "shard's points are not represented in the survivors' "
                "result"
            )
        missing = [int(p) for p in np.nonzero(root_mask)[0]]
        r_root = _node_r(topology.depth, 0, root_mask, **nr)
        get = dict(pid=pid, level=topology.depth, timeout_ms=deadline_ms)
        root_feats = torch.from_numpy(_kv_get(
            store, f"{tag}/final/f", (r_root, d), np.float32,
            what="root medoid features", **get)).to(dev)
        root_gidx = torch.from_numpy(_kv_get(
            store, f"{tag}/final/g", (r_root,), np.int64,
            what="root medoid global ids", **get))

        # -- exact re-weighting over the surviving shards -----------------
        # Partials combined in pid order over the non-excluded pids, as the
        # host driver accumulates in leaf order.
        local_counts, local_cov = reweight(feats_local, root_feats, squared_coverage)
        _put(store, f"{tag}/rw/{pid}",
             torch.cat([local_counts, local_cov.reshape(1)]))
        counts = torch.zeros((r_root,), dtype=torch.float32, device=dev)
        coverage = torch.zeros((), dtype=torch.float32, device=dev)
        for p in range(nproc):
            if root_mask[p]:
                continue
            part = torch.from_numpy(_kv_get(
                store, f"{tag}/rw/{p}", (r_root + 1,), np.float32,
                what="re-weight partial", **get)).to(dev)
            counts = counts + part[:r_root]
            coverage = coverage + part[r_root]
    finally:
        hb.close()

    wire = wire_bytes_plan(topology, r_local, r_node, d, compress)
    health_rec = {
        "degraded": bool(missing),
        "missing_pids": missing,
        "quorum": (nproc - len(missing)) / nproc,
        "min_quorum": float(health.min_quorum),
        "r_final": int(r_root),
        "level_deadline_s": deadline_s,
    }
    return TreeSelection(root_gidx, counts, coverage, wire, health_rec)
