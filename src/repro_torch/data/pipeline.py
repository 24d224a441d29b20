"""Data pipeline: coreset-aware sampling, batch assembly, background prefetch.

Port of ``repro.data.pipeline`` (``CoresetSampler``, ``GlobalBatcher``,
``Prefetcher``): numpy on the host, a copy of the reference's, so a seed
gives the reference's batch order index for index.

  CoresetSampler   — (indices, γ weights) per step: a shuffled epoch
                     iterator over the full data (γ = 1), or over the
                     installed weighted coreset (paper Eq. 20).  A refresh
                     is ``stage``d into a versioned back buffer from any
                     thread and ``install_pending``ed at a step boundary;
                     both buffers round-trip through ``state_dict``.
  GlobalBatcher    — {tokens, labels, weights, indices} numpy batches from
                     an index-addressable dataset.
  Prefetcher       — background thread, depth-k queue; worker failures
                     re-raise on the consumer.

:func:`to_device` turns a numpy batch into tensors on a device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

__all__ = ["CoresetSampler", "GlobalBatcher", "Prefetcher", "to_device"]


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch → tensors on ``device`` (integer arrays as int64)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        a = np.ascontiguousarray(a.astype(np.int64) if a.dtype.kind in "iu" else a)
        t = torch.from_numpy(a)
        out[k] = t.to(device, non_blocking=True)
    return out



class CoresetSampler:
    """Per-epoch index/weight sampler with optional active coreset."""

    def __init__(self, n: int, batch: int, seed: int = 0):
        self.n = n
        self.batch = batch
        self.seed = seed
        self.epoch = 0
        self.step_in_epoch = 0
        self.version = 0  # version of the installed coreset (0 = full data)
        self._indices: np.ndarray | None = None  # active coreset (None=full)
        self._weights: np.ndarray | None = None
        self._pending: dict | None = None  # staged back buffer (see stage())
        self._lock = threading.Lock()

    # -- coreset management ---------------------------------------------

    def set_coreset(
        self,
        indices: np.ndarray,
        weights: np.ndarray,
        keep_order: bool = False,
        version: int | None = None,
    ) -> None:
        """keep_order=True preserves the greedy selection order (paper §3.2:
        early elements carry most of the gradient approximation — useful for
        curriculum-style first epochs); default canonicalizes by index."""
        idx, w = self._canonicalize(indices, weights, keep_order)
        with self._lock:
            self._indices, self._weights = idx, w
            self.version = self.version + 1 if version is None else int(version)

    def set_coreset_from_selection(
        self,
        selection,
        pool_indices: np.ndarray | None = None,
        keep_order: bool = False,
    ) -> None:
        """Install a ``CoresetSelection`` as the active coreset.

        ``pool_indices`` maps selection positions back to corpus positions
        when selection ran over a strided/sampled candidate pool (the
        trainer's refresh path); None means the selection indexed the corpus
        directly.
        """
        idx = np.asarray(selection.indices)
        if pool_indices is not None:
            idx = np.asarray(pool_indices)[idx]
        self.set_coreset(idx, selection.weights, keep_order=keep_order)

    def clear_coreset(self) -> None:
        with self._lock:
            self._indices = self._weights = None
            self._pending = None
            self.version = 0

    # -- versioned double buffer (async refresh, DESIGN.md §4) ------------

    @staticmethod
    def _canonicalize(indices, weights, keep_order: bool):
        idx = np.asarray(indices)
        w = np.asarray(weights, np.float32)
        if not keep_order:
            order = np.argsort(idx)
            idx, w = idx[order], w[order]
        return idx, w

    def stage(
        self,
        indices: np.ndarray,
        weights: np.ndarray,
        version: int | None = None,
        meta: dict | None = None,
        keep_order: bool = False,
    ) -> int:
        """Publish a refresh into the back buffer (callable from any thread).

        The staged coreset does not affect iteration until the owner of the
        step loop calls :meth:`install_pending` at a step boundary.  ``meta``
        is an arbitrary JSON-able payload (ε̂, selection wall-clock, …) that
        rides along through checkpoints.  Returns the staged version.
        """
        idx, w = self._canonicalize(indices, weights, keep_order)
        with self._lock:
            if version is None:
                version = self.version + 1
            self._pending = {
                "version": int(version),
                "indices": idx,
                "weights": w,
                "meta": meta,
            }
            return int(version)

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    @property
    def pending_version(self) -> int | None:
        p = self._pending
        return None if p is None else p["version"]

    def install_pending(self) -> dict | None:
        """Atomically swap the staged back buffer in as the active coreset.

        Call only from the thread that owns iteration, at a step boundary
        (the cursor semantics of an epoch assume a fixed active set).
        Returns the installed record ({version, indices, weights, meta}) or
        None when nothing is staged.
        """
        with self._lock:
            if self._pending is None:
                return None
            p, self._pending = self._pending, None
            self._indices = p["indices"]
            self._weights = p["weights"]
            self.version = p["version"]
            return p

    @property
    def active_size(self) -> int:
        return self.n if self._indices is None else len(self._indices)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.active_size // self.batch)

    # -- iteration --------------------------------------------------------

    def _epoch_perm(self) -> np.ndarray:
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(self.active_size)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (pool indices (B,), γ weights (B,)) and advances."""
        perm = self._epoch_perm()
        lo = self.step_in_epoch * self.batch
        sel = perm[lo : lo + self.batch]
        if len(sel) < self.batch:  # wrap within epoch (drop-last semantics)
            sel = np.concatenate([sel, perm[: self.batch - len(sel)]])
        if self._indices is None:
            idx = sel
            w = np.ones((self.batch,), np.float32)
        else:
            idx = self._indices[sel]
            w = self._weights[sel]
            # normalize weights to mean≈1 so the lr scale is comparable to
            # full-data training (γ sums to n over the coreset's r elements)
            w = w * (len(self._indices) / max(self._weights.sum(), 1e-9))
        self.step_in_epoch += 1
        if self.step_in_epoch >= self.steps_per_epoch:
            self.step_in_epoch = 0
            self.epoch += 1
        return idx, w.astype(np.float32)

    # -- fault tolerance ----------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot: cursor + installed front buffer + staged back
        buffer — a checkpoint between publish and install loses nothing."""
        with self._lock:
            pending = None
            if self._pending is not None:
                pending = {
                    "version": self._pending["version"],
                    "indices": self._pending["indices"].tolist(),
                    "weights": self._pending["weights"].tolist(),
                    "meta": self._pending["meta"],
                }
            return {
                "epoch": self.epoch,
                "step_in_epoch": self.step_in_epoch,
                "version": self.version,
                "indices": None if self._indices is None else self._indices.tolist(),
                "weights": None if self._weights is None else self._weights.tolist(),
                "pending": pending,
            }

    def load_state_dict(self, s: dict) -> None:
        self.epoch = int(s["epoch"])
        self.step_in_epoch = int(s["step_in_epoch"])
        if s["indices"] is None:
            self.clear_coreset()
        else:
            with self._lock:
                self._indices = np.asarray(s["indices"], np.int64)
                self._weights = np.asarray(s["weights"], np.float32)
        # version/pending are absent in pre-refresh checkpoints
        version = int(s.get("version", 0 if s["indices"] is None else 1))
        with self._lock:
            self.version = version
        p = s.get("pending")
        if p is not None:
            self.stage(
                np.asarray(p["indices"], np.int64),
                np.asarray(p["weights"], np.float32),
                version=int(p["version"]),
                meta=p.get("meta"),
                keep_order=True,  # already canonicalized when staged
            )
        else:
            with self._lock:
                self._pending = None

    def skip_to(self, epoch: int, step_in_epoch: int) -> None:
        """Straggler/restart skip-ahead: O(1), no data regeneration."""
        self.epoch = epoch
        self.step_in_epoch = step_in_epoch


class GlobalBatcher:
    """Assembles model-ready global batches from an indexable dataset."""

    def __init__(self, dataset, sampler: CoresetSampler):
        self.dataset = dataset
        self.sampler = sampler

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def next(self) -> dict[str, np.ndarray]:
        idx, w = self.sampler.next_batch()
        batch = self.dataset.batch(idx)
        batch["weights"] = w
        batch["indices"] = idx.astype(np.int64)
        return batch


class _WorkerFailed:
    """Queue sentinel carrying the prefetch worker's exception."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _WorkerDone:
    """Queue sentinel: the wrapped iterator is exhausted."""


class Prefetcher:
    """Depth-k background prefetch of host batches.

    Worker outcomes travel through the queue itself: an exception or
    exhaustion in the wrapped iterator is re-raised (or raises
    StopIteration) from ``next()`` on the consumer thread instead of dying
    silently on the worker and leaving ``next()`` blocked forever.
    """

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
                self._q.put(_WorkerDone())
            except BaseException as e:
                self._q.put(_WorkerFailed(e))

        self._t = threading.Thread(
            target=worker, name="prefetcher", daemon=True
        )
        self._t.start()

    def next(self):
        item = self._q.get()
        if isinstance(item, _WorkerFailed):
            raise RuntimeError("prefetch worker failed") from item.exc
        if isinstance(item, _WorkerDone):
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # Drain until the worker (possibly blocked on a full queue) observes
        # the stop flag and exits; daemon status still covers a source
        # iterator wedged inside its own next().
        while self._t.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.1)
