"""Proxy extraction over a candidate pool, on one device or over a mesh.

Port of ``repro.core.extract``.  ``ProxyExtractor`` runs
``select_fn(params, batch) → (B, D)`` over the pool in batches of
``batch_size`` and returns the (n_pool, D) features in pool order, on the
parameters' device (the mesh's first device with a ``Mesh``, this rank's
device with a ``DeviceMesh``), ready for ``CraigSelector.select``.

The reference folds ``megabatch`` batches into one ``lax.scan`` dispatch;
PyTorch runs eagerly, so here :func:`make_scan_extract` is a loop of one
``select_fn`` call per batch, ``megabatch`` is the number of batches
assembled per host call (``dataset.batch``), and with ``prefetch`` the
next megabatch is assembled on a background thread while the device works
on the current one.  Batch contents are the reference's: index slots past
the pool wrap around to its head, and the tail rows are cut from the
features.  With a ``mesh`` each megabatch's batches split over
``axis_name``, every shard runs the same scan body over its contiguous
slice on its device, and the features concatenate in pool order
(``core.distributed.make_distributed_extract``).  Over a one-axis
``DeviceMesh`` of ranks every rank calls ``extract`` with the same pool and
parameters, plans the same dispatches, assembles only its own slice of
each, and ends with the whole gathered features, which then feed
``CraigSelector.select_distributed`` over the same mesh.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch import spans
from repro_torch.data.pipeline import Prefetcher, to_device
from repro_torch.faults import fault_value

__all__ = ["ProxyExtractor", "make_scan_extract"]


def make_scan_extract(select_fn):
    """The one megabatch body: ``fn(params, batches) → (M·B, D)`` for a
    dict of (M, B, ...) tensors, one ``select_fn`` call per batch in
    order.  Shared by the single-device extractor and the mesh path, so
    the two cannot diverge."""

    def scan_extract(params, batches: dict) -> torch.Tensor:
        m = next(iter(batches.values())).shape[0]
        return torch.cat(
            [select_fn(params, {k: v[i] for k, v in batches.items()})
             for i in range(m)], dim=0)

    return scan_extract


class ProxyExtractor:
    """Runs ``select_fn(params, batch) → (B, D)`` over a candidate pool.

    Args:
      select_fn: the proxy forward (``train.make_select_step``).
      dataset: index-addressable dataset (``batch(idx) → dict`` of numpy).
      batch_size: pool batch B.
      megabatch: pool batches assembled per host call.
      prefetch: assemble the next megabatch on a background thread.
      mesh / axis_name: optional data-parallel mesh: batches split over
        ``axis_name``.  A ``launch.mesh.Mesh``: each shard extracts on its
        device with the parameters replicated there.  A one-axis
        ``DeviceMesh`` named ``axis_name``: this rank extracts its shard on
        its device (``core.distributed.rank_device``), where the
        parameters already are, and the features are gathered over the
        axis's group.
    """

    def __init__(
        self,
        select_fn: Callable[[Any, dict], torch.Tensor],
        dataset,
        batch_size: int,
        *,
        megabatch: int = 8,
        prefetch: bool = True,
        mesh=None,
        axis_name: str = "data",
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be ≥ 1, got {batch_size}")
        if megabatch < 1:
            raise ValueError(f"megabatch must be ≥ 1, got {megabatch}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.megabatch = int(megabatch)
        self.prefetch = bool(prefetch)
        self._shard = None  # this rank's shard over a DeviceMesh
        if mesh is None:
            self._n_shards = 1
            self._device = None  # the parameters' device
            self._scan = make_scan_extract(select_fn)
            return
        from repro_torch.core import distributed as cd

        if cd.is_rank_mesh(mesh):
            self._scan = cd.make_rank_extract(select_fn, mesh, axis_name)
            self._n_shards, self._shard = mesh.size(), cd.rank_index(mesh)
            self._device = cd.rank_device(mesh)
        else:
            self._n_shards = int(mesh.shape[axis_name])
            self._device = mesh.axis_devices(axis_name)[0]
            self._scan = cd.make_distributed_extract(select_fn, mesh, axis_name)

    def _plan(self, n_pool: int) -> list[tuple[int, int]]:
        """[(first batch, batch count)] per host assembly.

        Every count is a multiple of the shard count (the mesh path splits
        it evenly); only the last may be smaller than ``megabatch``.
        """
        m_total = -(-n_pool // self.batch_size)
        per = self.megabatch + (-self.megabatch) % self._n_shards
        plan = []
        lo = 0
        while lo < m_total:
            m = min(per, m_total - lo)
            m += (-m) % self._n_shards  # pad the batch count to a shard multiple
            plan.append((lo, m))
            lo += m
        return plan

    def _own(self, lo: int, m: int) -> tuple[int, int]:
        """The batches of dispatch (lo, m) this process assembles: all of
        them, or over a ``DeviceMesh`` this rank's contiguous slice."""
        if self._shard is None:
            return lo, m
        per = m // self._n_shards
        return lo + self._shard * per, per

    def _assemble(self, pool_idx: np.ndarray, lo: int, m: int) -> dict:
        """Host work: one (m, B, ...) megabatch, index slots wrapping past
        the pool."""
        b = self.batch_size
        flat = np.arange(lo * b, (lo + m) * b) % len(pool_idx)
        with spans.span("extract.assemble"):
            batch = self.dataset.batch(pool_idx[flat])
            return {k: np.asarray(v).reshape((m, b) + np.shape(v)[1:])
                    for k, v in batch.items()}

    def _run(self, params, mb: dict, device) -> torch.Tensor:
        with spans.span("extract.dispatch"):
            return self._scan(params, to_device(mb, device))

    @torch.no_grad()
    def extract(self, params: dict, pool_idx: np.ndarray) -> torch.Tensor:
        """Proxy features (n_pool, D) fp32 for ``pool_idx``, in pool order,
        on the parameters' device (the mesh's first device with a ``Mesh``;
        with a ``DeviceMesh``, the whole features on every rank's device)."""
        with spans.span("extract"):
            pool_idx = np.asarray(pool_idx)
            n_pool = len(pool_idx)
            if n_pool == 0:
                raise ValueError("empty candidate pool")
            device = (next(iter(params.values())).device if self._device is None
                      else self._device)
            plan = self._plan(n_pool)
            outs: list[torch.Tensor] = []
            if self.prefetch and len(plan) > 1:
                def tagged():
                    try:
                        for lo, m in plan:
                            yield None, self._assemble(pool_idx, *self._own(lo, m))
                    except Exception as e:  # re-raised on the caller's thread
                        yield e, None

                pf = Prefetcher(tagged(), depth=2)
                try:
                    for _ in plan:
                        err, mb = pf.next()
                        if err is not None:
                            raise err
                        outs.append(self._run(params, mb, device))
                finally:
                    pf.close()
            else:
                for lo, m in plan:
                    outs.append(self._run(params, self._assemble(pool_idx, *self._own(lo, m)),
                                          device))
            feats = torch.cat(outs, dim=0)[:n_pool]
        # lets tests corrupt extracted features (kind='nan') to exercise
        # the selector's validate_features guard
        return fault_value("extract.features", feats, n_pool=n_pool)
