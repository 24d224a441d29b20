"""The program's spans (``repro_torch.spans``) on the CPU: off, they cost a
shared null context and leave no event in a trace; on, under a profiler
that records every thread, a tiny trainer with an asynchronous refresh
records the training loop's spans, nested as they are opened, and the
refresh's on its worker thread."""
import contextlib

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity

from repro_torch import spans
from repro_torch.core.craig import CraigConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, constant
from repro_torch.train import Trainer, TrainerConfig
import torch_threads  # noqa: F401 — one intra-op thread a worker

CFG = ModelConfig(name="tiny", family="dense", n_layers=1, d_model=16, n_heads=2,
                  n_kv_heads=2, d_ff=32, vocab_size=64, logit_chunk=16)

# span -> the span it opens inside, on the same thread
PARENT = {"step.install": "step", "step.submit": "step", "step.data": "step",
          "step.forward": "step", "step.backward": "step", "step.optimizer": "step",
          "step.sync": "step", "extract": "refresh", "extract.assemble": "extract",
          "extract.dispatch": "extract", "select": "refresh"}
TRAINING = {"step", *(k for k in PARENT if k.startswith("step."))}
WORKER = {"refresh", "extract", "extract.dispatch", "select", "publish"}


def _trainer(microbatches=1):
    ds = TokenStream(n_docs=16, seq_len=8, vocab_size=64, n_topics=4)
    tcfg = TrainerConfig(batch_size=4, select_every_epochs=1, proxy_pool_batches=4,
                         craig=CraigConfig(fraction=0.5, per_class=False),
                         refresh_mode="async", microbatches=microbatches)
    return Trainer(CFG, tcfg, ds, adamw(constant(1e-3)),
                   lambda: init_params(CFG, torch.Generator().manual_seed(0)), device="cpu")


def _profiled(trainer, on: bool, steps: int):
    """Program events [(name, thread, start, end)] of ``steps`` steps and
    the refreshes they start, recorded on every thread."""
    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    spans.enable(on)
    try:
        prof.start()
        try:
            trainer.run(steps)
            trainer.refresher.wait(timeout=60)
        finally:
            prof.stop()
    finally:
        spans.enable(False)
    return [(ev.name()[len(spans.PREFIX):], ev.start_thread_id(), ev.start_ns(),
             ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith(spans.PREFIX)]


def test_spans_off_are_one_shared_null_context_and_leave_no_event():
    assert spans.span("step") is spans.span("extract")
    assert isinstance(spans.span("step"), contextlib.nullcontext)
    assert _profiled(_trainer(), on=False, steps=5) == []


@pytest.mark.parametrize("microbatches", [1, 2])
def test_spans_on_record_the_training_and_the_refresh_threads(microbatches):
    trainer = _trainer(microbatches)
    main_steps = 9  # the full-data epoch, then coreset epochs: installs and submits
    events = _profiled(trainer, on=True, steps=main_steps)
    names = {e[0] for e in events}
    assert TRAINING | WORKER | {"extract.assemble"} <= names
    steps = [e for e in events if e[0] == "step"]
    main = {e[1] for e in steps}
    assert len(steps) == main_steps and len(main) == 1
    for name in TRAINING:
        assert {e[1] for e in events if e[0] == name} == main, name
    for name in WORKER:
        threads = {e[1] for e in events if e[0] == name}
        assert threads and not threads & main, name
    # every span lies inside its parent, on the same thread
    for name, parent, th, a, b in ((e[0], PARENT.get(e[0]), *e[1:]) for e in events):
        if parent is None:
            continue
        assert any(p[0] == parent and p[1] == th and p[2] <= a and b <= p[3]
                   for p in events), (name, parent)
    # forward and backward open once a microbatch, the optimizer once a step
    for name, per_step in (("step.forward", microbatches), ("step.backward", microbatches),
                           ("step.optimizer", 1), ("step.data", 1), ("step.sync", 1)):
        assert sum(e[0] == name for e in events) == per_step * main_steps, name
    # the step record keeps the time the data span covers
    records = [m for m in trainer.metrics_log if m["event"] == "step"]
    assert len(records) == main_steps and all(m["data_time_s"] > 0 for m in records)
