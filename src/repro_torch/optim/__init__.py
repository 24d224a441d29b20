"""Optimizers (port of ``repro.optim``): the LM optimizers and schedules,
and the weighted incremental-gradient runners for the convex case."""
from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    constant,
    exponential_decay,
    global_norm,
    k_inverse,
    momentum,
    sgd,
    warmup_cosine,
)
from repro_torch.optim.variance_reduced import ig_run, saga_run, svrg_run

__all__ = [
    "OptState",
    "Optimizer",
    "sgd",
    "momentum",
    "adamw",
    "global_norm",
    "clip_by_global_norm",
    "constant",
    "exponential_decay",
    "k_inverse",
    "warmup_cosine",
    "ig_run",
    "saga_run",
    "svrg_run",
]
