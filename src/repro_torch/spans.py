"""Spans at the program's layer boundaries, for a ``torch.profiler`` trace.

``span(name)`` marks one piece of work as ``"repro_torch." + name``: a
``torch.profiler.record_function``, so the span is an event of the same
trace as the kernels it launches and shares the profiler's clock with the
device timeline.  While spans are off (the default) ``span`` returns one
shared ``contextlib.nullcontext()`` and costs a call and a bool test; a
bare ``record_function`` costs microseconds a span even with no profiler
running, so the switch is a plain bool, flipped by whoever starts a
profiler.  It is process-wide, as the profiler it serves is.

To record the spans of every thread (the refresh runs on a worker thread
that each submit starts)::

    from torch._C._profiler import _ExperimentalConfig
    from repro_torch import spans

    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    spans.enable(True)
    prof.start()
    ...                                   # train
    prof.stop()
    spans.enable(False)

Without ``profile_all_threads`` only the thread that started the profiler
is recorded; a thread started before ``prof.start()`` is not recorded
either way.  ``torch.autograd._profiler_enabled()`` reads False on the
other threads of such a profile, so it cannot stand in for the switch.

The spans (thread: T the training loop's, R the refresh worker's):

  step              T  one iteration of ``Trainer.run``: install check to step record
  step.install      T  ``Trainer._install_refresh``: wait out the refresh, install it
  step.submit       T  the refresh's submit: parameter snapshot and thread start
  step.data         T  ``next_batch`` → ``dataset.batch`` → ``to_device``
  step.forward      T  the loss (once a microbatch)
  step.backward     T  ``torch.autograd.grad`` (once a microbatch)
  step.optimizer    T  ``optimizer.update``
  step.sync         T  ``float(loss)``: the wait for the step's kernels
  refresh           R  one attempt of a refresh job (``AsyncRefresher._run_job``)
  extract           R  ``ProxyExtractor.extract``
  extract.assemble  R  one megabatch's host assembly (or the prefetch thread)
  extract.dispatch  R  one megabatch's copy to the device and select steps
  select            R  ``CraigSelector.select`` of a refresh
  publish           R  the refresh's ``on_complete`` (staging the selection)
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["PREFIX", "enable", "span"]

PREFIX = "repro_torch."

_NULL = contextlib.nullcontext()
_on = False


def enable(flag: bool) -> None:
    """Turn the spans on or off (process-wide)."""
    global _on
    _on = bool(flag)


def span(name: str):
    """Context manager marking ``"repro_torch." + name`` in a profiler
    trace while spans are on; the shared null context while they are off."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)
