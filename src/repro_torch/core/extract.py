"""Proxy extraction over a candidate pool, on one device.

Port of ``repro.core.extract.ProxyExtractor`` (single device).  It runs
``select_fn(params, batch) → (B, D)`` over the pool in batches of
``batch_size`` and returns the (n_pool, D) features in pool order, on the
parameters' device, ready for ``CraigSelector.select``.

The reference folds ``megabatch`` batches into one ``lax.scan`` dispatch;
PyTorch runs eagerly, so here ``megabatch`` is the number of batches
assembled per host call (``dataset.batch``), and with ``prefetch`` the
next megabatch is assembled on a background thread while the device works
on the current one.  Batch contents are the reference's: index slots past
the pool wrap around to its head, and the tail rows are cut from the
features.  The data-parallel extract (``mesh``) is not ported yet
(ROADMAP.md queue 1, slice 4).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.pipeline import Prefetcher, to_device
from repro_torch.faults import fault_value

__all__ = ["ProxyExtractor"]


class ProxyExtractor:
    """Runs ``select_fn(params, batch) → (B, D)`` over a candidate pool.

    Args:
      select_fn: the proxy forward (``train.make_select_step``).
      dataset: index-addressable dataset (``batch(idx) → dict`` of numpy).
      batch_size: pool batch B.
      megabatch: pool batches assembled per host call.
      prefetch: assemble the next megabatch on a background thread.
      mesh: not ported; must be None.
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
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be ≥ 1, got {batch_size}")
        if megabatch < 1:
            raise ValueError(f"megabatch must be ≥ 1, got {megabatch}")
        if mesh is not None:
            raise NotImplementedError(
                "the data-parallel extract is not ported to repro_torch "
                "(ROADMAP.md queue 1, slice 4 'Distributed selection')"
            )
        self.select_fn = select_fn
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.megabatch = int(megabatch)
        self.prefetch = bool(prefetch)

    def _plan(self, n_pool: int) -> list[tuple[int, int]]:
        """[(first batch, batch count)] per host assembly."""
        m_total = -(-n_pool // self.batch_size)
        return [(lo, min(self.megabatch, m_total - lo))
                for lo in range(0, m_total, self.megabatch)]

    def _assemble(self, pool_idx: np.ndarray, lo: int, m: int) -> dict:
        """Host work: m batches of B pool rows, wrapping past the pool."""
        b = self.batch_size
        flat = np.arange(lo * b, (lo + m) * b) % len(pool_idx)
        return self.dataset.batch(pool_idx[flat])

    def _run(self, params, mb: dict, device) -> list[torch.Tensor]:
        batch = to_device(mb, device)
        n = next(iter(batch.values())).shape[0]
        b = self.batch_size
        return [self.select_fn(params, {k: v[i:i + b] for k, v in batch.items()})
                for i in range(0, n, b)]

    @torch.no_grad()
    def extract(self, params: dict, pool_idx: np.ndarray) -> torch.Tensor:
        """Proxy features (n_pool, D) fp32 for ``pool_idx``, in pool order,
        on the parameters' device."""
        pool_idx = np.asarray(pool_idx)
        n_pool = len(pool_idx)
        if n_pool == 0:
            raise ValueError("empty candidate pool")
        device = next(iter(params.values())).device
        plan = self._plan(n_pool)
        outs: list[torch.Tensor] = []
        if self.prefetch and len(plan) > 1:
            def tagged():
                try:
                    for lo, m in plan:
                        yield None, self._assemble(pool_idx, lo, m)
                except Exception as e:  # re-raised on the caller's thread
                    yield e, None

            pf = Prefetcher(tagged(), depth=2)
            try:
                for _ in plan:
                    err, mb = pf.next()
                    if err is not None:
                        raise err
                    outs.extend(self._run(params, mb, device))
            finally:
                pf.close()
        else:
            for lo, m in plan:
                outs.extend(self._run(params, self._assemble(pool_idx, lo, m), device))
        feats = torch.cat(outs, dim=0)[:n_pool]
        # lets tests corrupt extracted features (kind='nan') to exercise
        # the selector's validate_features guard
        return fault_value("extract.features", feats, n_pool=n_pool)
