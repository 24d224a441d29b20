"""Asynchronous coreset refresh with supervised retries.

Port of ``repro.core.refresh`` (``AsyncRefresher``, ``RefreshResult``).
CRAIG re-selects its coreset periodically (paper §3.4: deep-net proxies
drift with w); a refresh that blocked the step loop would put proxy
extraction and selection on the training critical path.  The refresher
moves it off:

    trigger boundary: snapshot params → worker thread: extract + select →
    publish (``on_complete`` stages it) → next epoch boundary: install

and training continues on the stale coreset in between (double
buffering).  ``mode='sync'`` runs the same lifecycle with the work inline
at submit, so the two modes are step-for-step replicas.

The snapshot differs from the reference's: JAX arrays are immutable and
are held by reference there, but the port's optimizer updates parameters
in place, so ``submit`` copies every tensor (on its own device) and every
numpy array.  At most one job is in flight.

Each job runs under a :class:`~repro_torch.faults.FailurePolicy`: retries
with exponential backoff on the worker, then re-raise at the caller's
next ``wait``/``collect``/``submit`` (``'raise'``), abandon and call
``on_failure`` (``'keep_stale'``), or one inline re-run at the caller's
next touch point (``'sync_fallback'``).

With an ``ingest_fn`` the refresher also serves the streaming path (the
coreset service): :meth:`AsyncRefresher.ingest` queues pool deltas and
drains the queue as one coalesced ``ingest_fn(deltas)`` job whenever the
worker is idle — the same job slot and publish lifecycle, one version per
drain.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Any, Callable, Literal

import numpy as np
import torch

from repro_torch import spans
from repro_torch.faults import FailurePolicy, fault_point

__all__ = ["AsyncRefresher", "RefreshResult", "snapshot", "weak_callback"]


@dataclasses.dataclass
class RefreshResult:
    """A published refresh: ``work_fn``'s value plus provenance.

    ``version`` is the monotone counter assigned at submit (the sampler's
    buffer versions); ``attempts`` counts work attempts; ``fell_back``
    marks a result of the ``'sync_fallback'`` inline re-run.
    """

    version: int
    value: Any
    wall_time_s: float
    error: BaseException | None = None
    attempts: int = 1
    fell_back: bool = False


def snapshot(tree: Any) -> Any:
    """Deep copy of tensors (same device) and numpy arrays in nested
    dicts, lists and tuples; other leaves by reference."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree


def weak_callback(method: Callable) -> Callable:
    """``method`` (bound) called through a weak reference to its object, so
    that a refresher does not hold its owner alive in a reference cycle."""
    ref, name = weakref.WeakMethod(method), method.__qualname__

    def call(*args):
        bound = ref()
        if bound is None:
            raise ReferenceError(f"{name}: its owner was freed")
        return bound(*args)

    return call


class AsyncRefresher:
    """Runs ``work_fn(params_snapshot)`` off the training critical path.

    ``on_complete`` fires with each successful ``RefreshResult`` (on the
    worker thread in async mode); results also publish to one slot read by
    :meth:`collect`.  Worker threads are non-daemon, so interpreter
    shutdown joins them rather than tearing down under a running kernel.
    """

    def __init__(
        self,
        work_fn: Callable[[Any], Any],
        mode: Literal["sync", "async"] = "async",
        on_complete: Callable[[RefreshResult], None] | None = None,
        ingest_fn: Callable[[list], Any] | None = None,
        failure_policy: FailurePolicy | None = None,
        on_failure: Callable[[RefreshResult], None] | None = None,
    ):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown refresh mode {mode!r}")
        self._work_fn = work_fn
        self._mode = mode
        self._on_complete = on_complete
        self._ingest_fn = ingest_fn
        self._pending: list = []
        self._policy = failure_policy or FailurePolicy()
        self._on_failure = on_failure
        self._version = 0
        self._thread: threading.Thread | None = None
        self._result: RefreshResult | None = None
        self._lock = threading.Lock()
        self._fallback: tuple[RefreshResult, Callable[[], Any]] | None = None
        self._last_failure: RefreshResult | None = None

    # -- state ---------------------------------------------------------------

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def version(self) -> int:
        """Version of the most recently submitted refresh (0 = none yet)."""
        return self._version

    @property
    def busy(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def failure_policy(self) -> FailurePolicy:
        return self._policy

    @property
    def last_failure(self) -> RefreshResult | None:
        """Most recent abandoned job (``on_exhaustion='keep_stale'``)."""
        with self._lock:
            return self._last_failure

    # -- lifecycle -----------------------------------------------------------

    def submit(self, params: Any) -> int:
        """Snapshot ``params`` and start (async) or run (sync) the refresh.

        Returns the new version.  Raises while a job is in flight (one
        back buffer, not a queue).  An uncollected failure of the previous
        job, or its pending ``sync_fallback`` re-run, is dealt with first.
        """
        self._run_fallback_if_pending()
        self._raise_if_failed()
        if self.busy:
            raise RuntimeError(
                f"refresh v{self._version} already in flight; collect it "
                "before submitting"
            )
        self._version += 1
        version = self._version
        snap = snapshot(params)
        self._launch(version, lambda: self._work_fn(snap), "refresh")
        return version

    def _launch(self, version: int, fn: Callable[[], Any], name: str) -> None:
        """Run ``fn`` as job ``version``: inline in sync mode, else on a
        new worker thread."""

        def job() -> None:
            try:
                self._run_job(version, fn)
            except BaseException as e:  # noqa: BLE001 — surfaced at wait()
                with self._lock:
                    self._result = RefreshResult(version, None, 0.0, error=e)

        if self._mode == "sync":
            job()
            self._run_fallback_if_pending()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(
                target=job, name=f"craig-{name}-v{version}", daemon=False
            )
            self._thread.start()

    # -- streaming ingest (coalescing) ---------------------------------------

    @property
    def pending_deltas(self) -> int:
        """Deltas queued for the next coalesced ingest drain."""
        with self._lock:
            return len(self._pending)

    def ingest(self, *deltas: Any) -> int | None:
        """Queue pool deltas and drain them through ``ingest_fn``.

        Where :meth:`submit` rejects while a job is in flight, ``ingest``
        coalesces: deltas enqueue unconditionally, and whenever no job is
        in flight the whole queue drains as ONE job, ``ingest_fn(deltas)``,
        publishing one ``RefreshResult``.  Returns the drained version, or
        None if the deltas queued behind an in-flight job (they drain at
        the next ingest/:meth:`wait`/:meth:`collect`).  Failures route as
        submit's do.
        """
        if self._ingest_fn is None:
            raise RuntimeError(
                "this refresher has no ingest_fn; pass one at construction "
                "to use the streaming ingest path"
            )
        if not deltas:
            raise ValueError("ingest() needs at least one delta")
        with self._lock:
            self._pending.extend(deltas)
        return self._drain()

    def _drain(self) -> int | None:
        """Start one coalesced ingest job if idle and deltas are queued."""
        if self.busy:
            return None
        self._run_fallback_if_pending()
        self._raise_if_failed()
        with self._lock:
            if not self._pending:
                return None
            batch, self._pending = self._pending, []
        self._version += 1
        version = self._version
        self._launch(version, lambda: self._ingest_fn(batch), "ingest")
        return version

    # -- supervised job runner -----------------------------------------------

    def _run_job(self, version: int, fn: Callable[[], Any]) -> None:
        policy = self._policy
        t0 = time.perf_counter()
        error: BaseException | None = None
        attempts = 0
        for attempt in range(policy.max_retries + 1):
            attempts += 1
            try:
                with spans.span("refresh"):
                    # inside the retry loop: max_retries heals an injected fault
                    fault_point("refresh.worker", version=version, attempt=attempt)
                    value = fn()
            except BaseException as e:  # noqa: BLE001 — routed via policy
                error = e
                if attempt < policy.max_retries:
                    time.sleep(policy.backoff_s(attempt))
                continue
            res = RefreshResult(version, value, time.perf_counter() - t0, attempts=attempts)
            try:
                if self._on_complete is not None:
                    with spans.span("publish"):
                        self._on_complete(res)
            except BaseException as e:  # noqa: BLE001 — not retryable
                self._exhaust(
                    RefreshResult(version, None, time.perf_counter() - t0, error=e,
                                  attempts=attempts),
                    fn, retryable=False,
                )
                return
            with self._lock:
                self._result = res
            return
        self._exhaust(
            RefreshResult(version, None, time.perf_counter() - t0, error=error,
                          attempts=attempts),
            fn, retryable=True,
        )

    def _exhaust(self, res: RefreshResult, fn: Callable[[], Any], *, retryable: bool) -> None:
        """Route a job whose attempts all failed; a publish failure
        (``retryable=False``) always raises, since re-running could stage
        the same version twice."""
        mode = self._policy.on_exhaustion
        if mode == "sync_fallback" and retryable:
            with self._lock:
                self._fallback = (res, fn)
            return
        if mode == "keep_stale":
            with self._lock:
                self._last_failure = res
            if self._on_failure is None:
                return
            try:
                self._on_failure(res)
            except BaseException as e:  # noqa: BLE001 — must not die silently
                with self._lock:
                    self._result = dataclasses.replace(res, error=e)
            return
        with self._lock:
            self._result = res

    def _run_fallback_if_pending(self) -> None:
        """The one inline re-run of an exhausted job ('sync_fallback')."""
        with self._lock:
            pending, self._fallback = self._fallback, None
        if pending is None:
            return
        failed, fn = pending
        t0 = time.perf_counter()
        try:
            value = fn()
            res = RefreshResult(failed.version, value,
                                failed.wall_time_s + time.perf_counter() - t0,
                                attempts=failed.attempts + 1, fell_back=True)
            if self._on_complete is not None:
                self._on_complete(res)
            with self._lock:
                self._result = res
        except BaseException as e:  # noqa: BLE001 — re-raised at wait()
            with self._lock:
                self._result = RefreshResult(
                    failed.version, None, failed.wall_time_s + time.perf_counter() - t0,
                    error=e, attempts=failed.attempts + 1, fell_back=True,
                )

    def reset_version(self, version: int) -> None:
        """Fast-forward the version counter (monotone across restarts)."""
        if self.busy:
            raise RuntimeError("cannot reset version while a refresh runs")
        self._version = max(self._version, int(version))

    def wait(self, timeout: float | None = None) -> None:
        """Block until no job is in flight, no queued deltas remain and no
        fallback is pending; re-raise a worker failure.  ``timeout`` is one
        deadline for all of it; on expiry a ``TimeoutError`` raises and the
        job keeps running, its outcome surfacing at the next touch point."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            t = self._thread
            if t is not None:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is None or remaining > 0:
                    t.join(remaining)
                if t.is_alive():
                    raise TimeoutError(f"refresh still running after {timeout}s")
                self._thread = None
            self._run_fallback_if_pending()
            self._raise_if_failed()
            if self._ingest_fn is not None and self._drain() is not None:
                continue
            return

    def collect(self, block: bool = False) -> RefreshResult | None:
        """Pop the published result, if any.  ``block=True`` waits first."""
        if block:
            self.wait()
        else:
            self._raise_if_failed()
        with self._lock:
            res, self._result = self._result, None
        return res

    def _raise_if_failed(self) -> None:
        with self._lock:
            res = self._result
            if res is not None and res.error is not None:
                self._result = None
            else:
                res = None
        if res is not None:
            raise RuntimeError(
                f"coreset refresh v{res.version} failed after {res.attempts} attempt(s)"
            ) from res.error
