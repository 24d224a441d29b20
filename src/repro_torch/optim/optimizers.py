"""Optimizers over flat parameter dicts, and learning-rate schedules.

Port of ``repro.optim.optimizers`` (``sgd``, ``momentum``, ``adamw``,
``global_norm``, ``clip_by_global_norm`` and the schedules ``constant``,
``exponential_decay``, ``k_inverse``, ``warmup_cosine``).  Parameters and
state are fp32 masters; each update is computed in fp32 and cast back to
the parameter's dtype, as in the reference.

Unlike the reference's pure functions, ``update`` writes the new values
into the parameter and state tensors in place and returns them: at
qwen3-1.7b width a second copy of parameters and AdamW moments would cost
another 24 GB.  Whoever must keep the old parameters (the asynchronous
refresh) copies them first.  Schedules map the step count (an int) to a
float.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

__all__ = [
    "OptState",
    "Optimizer",
    "sgd",
    "momentum",
    "adamw",
    "global_norm",
    "clip_by_global_norm",
    "exponential_decay",
    "k_inverse",
    "constant",
    "warmup_cosine",
]

Schedule = Callable[[int], float]


class OptState(NamedTuple):
    step: int
    inner: dict  # {"m": {name: tensor}, "v": {...}}, {"m": ...} or {}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], OptState]
    update: Callable[[dict, OptState, dict], tuple[dict, OptState]]
    """(grads, state, params) → (params, state), updated in place; the
    grads may be scaled in place by clipping."""


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


# -- schedules (paper §5.1) --------------------------------------------------


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def exponential_decay(lr0: float, b: float) -> Schedule:
    """α_k = α0 · b^k."""
    return lambda step: lr0 * b ** step


def k_inverse(lr0: float, b: float, tau: float = 1.0) -> Schedule:
    """α_k = α0 / (1 + b·k)^τ."""
    return lambda step: lr0 / (1.0 + b * step) ** tau


def warmup_cosine(lr0: float, warmup: int, total: int) -> Schedule:
    def sched(step):
        if step < warmup:
            return lr0 * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return lr0 * 0.5 * (1.0 + math.cos(math.pi * prog))

    return sched


# -- optimizers ---------------------------------------------------------------


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _apply(p: torch.Tensor, step: torch.Tensor) -> None:
    """p ← p − step, computed in fp32 and cast back to p's dtype."""
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p.float() - step)


@torch.no_grad()
def _maybe_clip(grads: dict, clip: float | None) -> dict:
    """``clip_by_global_norm`` in place: ``update`` owns its grads."""
    if clip is not None:
        scale = torch.clamp(clip / (global_norm(grads) + 1e-9), max=1.0)
        for g in grads.values():
            g.mul_(scale.to(g.dtype))
    return grads


def sgd(schedule: Schedule, clip: float | None = None) -> Optimizer:
    def init(params):
        return OptState(0, {})

    @torch.no_grad()
    def update(grads, state, params):
        grads = _maybe_clip(grads, clip)
        lr = schedule(state.step)
        for k, p in params.items():
            _apply(p, grads[k].float() * lr)
        return params, OptState(state.step + 1, {})

    return Optimizer(init, update)


def momentum(schedule: Schedule, beta: float = 0.9, clip: float | None = None) -> Optimizer:
    def init(params):
        return OptState(0, {"m": _zeros(params)})

    @torch.no_grad()
    def update(grads, state, params):
        grads = _maybe_clip(grads, clip)
        lr = schedule(state.step)
        m = state.inner["m"]
        for k, p in params.items():
            m[k].mul_(beta).add_(grads[k].float())
            _apply(p, m[k] * lr)
        return params, OptState(state.step + 1, {"m": m})

    return Optimizer(init, update)


def adamw(
    schedule: Schedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip: float | None = 1.0,
) -> Optimizer:
    def init(params):
        return OptState(0, {"m": _zeros(params), "v": _zeros(params)})

    @torch.no_grad()
    def update(grads, state, params):
        grads = _maybe_clip(grads, clip)
        step = state.step + 1
        lr = schedule(state.step)
        # bias corrections in fp32, as the reference computes them
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step)
        m, v = state.inner["m"], state.inner["v"]
        for k, p in params.items():
            g = grads[k].float()
            m[k].mul_(b1).add_(g, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            # one temporary a moment past m̂: at nemotron-4-15b's 1.57 B-element
            # embedding each is 6.3 GB
            delta = (m[k] / bc1).div_((v[k] / bc2).sqrt_().add_(eps))
            if weight_decay:
                delta.add_(p.float(), alpha=weight_decay)
            _apply(p, delta.mul_(lr))
        return params, OptState(step, {"m": m, "v": v})

    return Optimizer(init, update)
