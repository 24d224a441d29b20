"""Coreset as a service: submit pool deltas, read back (indices, γ, version).

Port of ``repro.serve.coreset_service``.  A ``CoresetService`` owns

  * a :class:`~repro_torch.core.engines.streaming.StreamingSelector`, the
    sieve-streaming state (O(Δn·k) per delta, no re-sweep);
  * the pool buffer, on the service's device (finalization needs the rows
    the selected indices point at);
  * an :class:`~repro_torch.core.refresh.AsyncRefresher` in ingest mode:
    deltas submitted while a drain is in flight coalesce into the next
    one, and every drain publishes one versioned selection;
  * a staged → installed double buffer: drains stage the newest
    selection, :meth:`CoresetService.coreset` installs it at the caller's
    boundary.

``launch/serve.py --coreset`` wraps this in a JSON-lines protocol.  Each
drain passes the ``service.ingest`` fault hook first.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Literal

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.engines.streaming import StreamingConfig, StreamingSelector
from repro_torch.core.refresh import AsyncRefresher, RefreshResult, weak_callback
from repro_torch.faults import FailurePolicy, fault_point

__all__ = ["CoresetService", "CoresetUpdate"]


def _no_submit(_params):  # pragma: no cover - guard, never runs in tests
    raise RuntimeError(
        "CoresetService drives its refresher through the ingest path; "
        "submit() has no meaning here"
    )


@dataclasses.dataclass(frozen=True)
class CoresetUpdate:
    """One installed selection: what a service client trains on.

    ``version`` is the refresher's drain counter; ``n_seen`` the pool size
    the selection covers; ``weights`` the γ cluster sizes (Σγ == n_live);
    ``n_live`` the rows surviving eviction (== n_seen unless the service
    evicts).  ``indices`` are global arrival positions, eviction or not.
    """

    version: int
    indices: np.ndarray
    weights: np.ndarray
    coverage: float
    n_seen: int
    n_live: int = -1


class CoresetService:
    """Submit pool deltas; read back the current (indices, γ, version).

    Args:
      budget: coreset size k, fixed for the service's lifetime.
      dim: proxy-feature dimension of arriving deltas.
      config: streaming engine knobs (sieve grid, finalize route).
      metric: 'l2' | 'cosine' (cosine via unit-normalized l2).
      per_class: stratified budgets ∝ observed class arrivals (paper §5);
        deltas then carry labels.
      mode: 'sync' — drains run inline in :meth:`submit_delta`; 'async' —
        drains run on the refresher's worker and coalesce while it is busy.
      evict: drop pool rows no sieve references after every drain (the
        pool stays O(L·k·d)); indices stay global arrival positions, and γ
        sums to ``n_live``.
      failure_policy: retry/backoff/exhaustion of ingest drains.  Drains
        are transactional: a failed attempt restores the selector and the
        pool, so a retry replays the same deltas against the same state.
        Under ``on_exhaustion='keep_stale'`` the failure is recorded
        (:meth:`pop_failure`) and the installed selection keeps serving.
      device: where the pool and the sieve states live (the card unless
        the caller asks for the CPU).
    """

    def __init__(
        self,
        budget: int,
        dim: int,
        *,
        config: StreamingConfig | None = None,
        metric: str = "l2",
        per_class: bool = False,
        mode: Literal["sync", "async"] = "sync",
        evict: bool = False,
        failure_policy: FailurePolicy | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.budget = int(budget)
        self.dim = int(dim)
        self.evict = bool(evict)
        self.selector = StreamingSelector(
            budget, dim, config=config, metric=metric, per_class=per_class,
            evict=evict, device=self.device,
        )
        # live pool rows in ingest order (worker-owned)
        self._pool = torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        self._lock = threading.Lock()
        self._staged: CoresetUpdate | None = None
        self._installed: CoresetUpdate | None = None
        self._failures: list[dict] = []  # keep_stale abandonments (worker-fed)
        # weak callbacks: the refresher must not keep the service (and its
        # pool on the card) alive in a reference cycle
        self.refresher = AsyncRefresher(
            _no_submit, mode=mode,
            ingest_fn=weak_callback(self._ingest_job),
            on_complete=weak_callback(self._stage),
            failure_policy=failure_policy,
            on_failure=weak_callback(self._note_failure),
        )

    # -- lifecycle -----------------------------------------------------------

    def submit_delta(self, feats, labels=None) -> int | None:
        """Queue one (Δn, dim) delta; returns the drained version, or None
        if it coalesced behind an in-flight drain (async mode)."""
        feats = torch.as_tensor(feats, dtype=torch.float32)
        if feats.dim() != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected (Δn, {self.dim}) features, got {tuple(feats.shape)}")
        labels = None if labels is None else np.asarray(labels).ravel()
        return self.refresher.ingest((feats.to(self.device), labels))

    def coreset(self, block: bool = True) -> CoresetUpdate | None:
        """Install and return the newest published selection (None before
        any).  ``block=True`` drains queued and in-flight ingests first;
        worker failures re-raise here."""
        if block:
            self.refresher.wait()
        with self._lock:
            if self._staged is not None:
                self._installed, self._staged = self._staged, None
            return self._installed

    @property
    def version(self) -> int:
        """Version of the most recently *installed* selection (0 = none)."""
        with self._lock:
            return 0 if self._installed is None else self._installed.version

    @property
    def n_seen(self) -> int:
        """Pool size ingested so far (includes staged-but-not-installed)."""
        return self.selector.n_seen

    def pop_failure(self) -> dict | None:
        """Pop the oldest recorded keep_stale abandonment, if any."""
        with self._lock:
            return self._failures.pop(0) if self._failures else None

    # -- worker side ---------------------------------------------------------

    def _ingest_job(self, deltas: list):
        """One coalesced drain: ingest every queued delta, evict dead rows
        if asked, finalize once.  Transactional: the selector and the pool
        return to their pre-drain state on any failure."""
        fault_point("service.ingest", n_deltas=len(deltas))
        snap = self.selector.snapshot()
        pool_snap = self._pool
        try:
            for feats, labels in deltas:
                self.selector.ingest(feats, labels=labels)
            pool = torch.cat([self._pool, *(f for f, _ in deltas)])
            if self.evict:
                keep = self.selector.compact()
                pool = pool[torch.as_tensor(keep, device=self.device)]
            self._pool = pool
            res = self.selector.result(pool)
            indices = res.indices.cpu().numpy().astype(np.int64)
            if self.evict:  # live-pool positions → global arrival ids
                indices = self.selector.live_ids[indices]
        except BaseException:
            self.selector.restore(snap)
            self._pool = pool_snap
            raise
        return (
            indices,
            res.weights.cpu().numpy().astype(np.float32),
            float(res.coverage),
            self.selector.n_rows,
        )

    def _note_failure(self, res: RefreshResult) -> None:
        """on_failure hook (keep_stale): record the abandoned drain."""
        err = res.error
        with self._lock:
            self._failures.append({
                "event": "craig_refresh_failed",
                "version": res.version,
                "attempts": res.attempts,
                "error": f"{type(err).__name__}: {err}",
            })

    def _stage(self, res: RefreshResult) -> None:
        indices, weights, coverage, n_live = res.value
        with self._lock:
            self._staged = CoresetUpdate(
                version=res.version, indices=indices, weights=weights,
                coverage=coverage, n_seen=self.selector.n_seen, n_live=n_live,
            )

    # -- serialization -------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot in the reference's format: selector state,
        pool buffer (one chunk of rows), install state.  Drains first, so
        an in-flight drain materializes before the save."""
        self.refresher.wait()
        with self._lock:
            installed = self._installed
        return {
            "selector": self.selector.state_dict(),
            "pool": [self._pool.cpu().tolist()],
            "installed": None if installed is None else {
                "version": installed.version,
                "indices": installed.indices.tolist(),
                "weights": installed.weights.tolist(),
                "coverage": installed.coverage,
                "n_seen": installed.n_seen,
                "n_live": installed.n_live,
            },
        }

    def load_state_dict(self, d: dict) -> None:
        """Inverse of :meth:`state_dict`; also takes the dict the
        reference's ``CoresetService.state_dict`` writes (its pool is a
        list of per-delta chunks)."""
        self.selector.load_state_dict(d["selector"])
        chunks = [np.asarray(p, np.float32).reshape(-1, self.dim) for p in d["pool"]]
        pool = np.concatenate(chunks) if chunks else np.zeros((0, self.dim), np.float32)
        self._pool = torch.from_numpy(pool).to(self.device)
        inst = d["installed"]
        with self._lock:
            self._staged = None
            self._installed = None if inst is None else CoresetUpdate(
                version=int(inst["version"]),
                indices=np.asarray(inst["indices"], np.int64),
                weights=np.asarray(inst["weights"], np.float32),
                coverage=float(inst["coverage"]),
                n_seen=int(inst["n_seen"]),
                n_live=int(inst.get("n_live", inst["n_seen"])),
            )
        self.refresher.reset_version(self.version)
