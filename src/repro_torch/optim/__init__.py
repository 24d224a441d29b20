"""Optimizers (port of ``repro.optim``; the LM optimizers come with slice 2)."""
from repro_torch.optim.variance_reduced import ig_run, saga_run, svrg_run

__all__ = ["ig_run", "saga_run", "svrg_run"]
