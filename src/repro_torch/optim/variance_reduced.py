"""Weighted incremental-gradient methods: IG, SAGA and SVRG (paper Fig. 1).

Port of ``repro.optim.variance_reduced``.  Full-fidelity versions for the
convex path (flat parameter vectors, per-example gradient oracles),
supporting the weighted IG step of paper Eq. 20: w ← w − α·γ_j·∇f_j(w).

Each run happens on ``w0.device``.  ``order`` and ``weights`` are read on
the host once, so a step indexes the data with a Python int (a view, no
device round trip); the reference's ``lax.scan`` over an epoch becomes a
Python loop.  Step sizes are rounded to fp32 as the reference's fp32
arrays round them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["ig_run", "saga_run", "svrg_run"]

GradFn = Callable[[torch.Tensor, int], torch.Tensor]
# grad_fn(w, i) → ∇f_i(w)  (single-example gradient, includes regularizer)


def _host(order, weights) -> tuple[list[int], np.ndarray]:
    order = np.asarray(torch.as_tensor(order).cpu(), np.int64).tolist()
    weights = np.asarray(torch.as_tensor(weights).cpu(), np.float32)
    if len(order) != weights.shape[0]:
        raise ValueError(f"order has {len(order)} entries, weights {weights.shape[0]}")
    return order, weights


def ig_run(
    grad_fn: GradFn,
    w0: torch.Tensor,
    order,
    weights,
    schedule: Callable[[int], float],
    epochs: int,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Plain (weighted) incremental gradient descent, paper Eq. 20.

    order: (r,) element indices (CRAIG subset, greedy order); weights: (r,) γ.
    Returns final w and per-epoch iterates.
    """
    order, weights = _host(order, weights)
    w = w0
    trace = []
    for k in range(epochs):
        alpha = np.float32(schedule(k))
        for i, gamma in zip(order, weights):
            w = w - float(alpha * gamma) * grad_fn(w, i)
        trace.append(w)
    return w, trace


def saga_run(
    grad_fn: GradFn,
    w0: torch.Tensor,
    order,
    weights,
    schedule: Callable[[int], float],
    epochs: int,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """SAGA over the weighted subset: gradient table over subset elements.

    Update: w ← w − α·γ_j·( ∇f_j(w) − table_j + mean(table) ).
    """
    order, weights = _host(order, weights)
    r = len(order)
    w = w0
    table = torch.stack([grad_fn(w0, i) for i in order])  # at w0
    gam = torch.as_tensor(weights, device=w0.device)
    mean_g = torch.mean(table * gam[:, None], dim=0)
    trace = []
    for k in range(epochs):
        alpha = np.float32(schedule(k))
        for pos, (i, gamma) in enumerate(zip(order, weights)):
            g = grad_fn(w, i)
            old = table[pos]
            w = w - float(alpha * gamma) * (g - old + mean_g)
            mean_g = mean_g + float(gamma) * (g - old) / r
            table[pos] = g
        trace.append(w)
    return w, trace


def svrg_run(
    grad_fn: GradFn,
    w0: torch.Tensor,
    order,
    weights,
    schedule: Callable[[int], float],
    epochs: int,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """SVRG: snapshot full (weighted-subset) gradient per epoch.

    μ = (1/r)Σ_j γ_j ∇f_j(w̃);  w ← w − α·(γ_j·(∇f_j(w) − ∇f_j(w̃)) + μ).
    """
    order, weights = _host(order, weights)
    r = len(order)
    w = w0
    trace = []
    for k in range(epochs):
        alpha = float(np.float32(schedule(k)))
        snapshot = w
        full_g = (
            torch.stack(
                [float(g_) * grad_fn(snapshot, i) for i, g_ in zip(order, weights)]
            ).sum(0)
            / r
        )
        for i, gamma in zip(order, weights):
            g = grad_fn(w, i)
            g_snap = grad_fn(snapshot, i)
            w = w - alpha * (float(gamma) * (g - g_snap) + full_g)
        trace.append(w)
    return w, trace
