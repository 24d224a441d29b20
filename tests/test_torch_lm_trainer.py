"""Refresh, extraction, checkpointing and the trainer of the port, against
the JAX reference and against themselves, on the CPU.

Tolerances: trainer losses against the reference trainer with fp32
compute: rtol 1e-4 (the train-step tolerance of test_torch_lm_train.py);
selections under the tie rule of ``repro_torch.parity``.  Port against port (sync
against async refresh, restart against an uninterrupted run): identical
losses — the same arithmetic in the same order.
"""
import gc
import json
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.core.craig import CraigConfig as JCraigConfig
from repro.core.extract import ProxyExtractor as JProxyExtractor
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train.train_step import make_select_step as jmake_select_step
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.craig import CraigConfig
from repro_torch.core.extract import ProxyExtractor
from repro_torch.core.refresh import AsyncRefresher
from repro_torch.data.synthetic import TokenStream
from repro_torch.faults import FailurePolicy
from repro_torch.launch.mesh import compat_mesh
from repro_torch.models import init_params
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, constant
from repro_torch.optim.optimizers import OptState
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.train_step import make_select_step
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

SMALL = dict(
    name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
    n_kv_heads=2, d_ff=64, vocab_size=128, logit_chunk=16,
)
CFG = ModelConfig(**SMALL)


def _trainer(tmp, seed=0, params=None, **kw):
    ds = TokenStream(n_docs=48, seq_len=24, vocab_size=128, n_topics=6)
    tcfg = TrainerConfig(
        batch_size=8,
        select_every_epochs=kw.pop("select_every_epochs", 2),
        checkpoint_dir=str(tmp) if tmp else None,
        checkpoint_every=kw.pop("checkpoint_every", 4),
        craig=kw.pop("craig", CraigConfig(fraction=0.5, per_class=False)),
        **kw,
    )

    def init():
        if params is not None:
            return {k: v.clone() for k, v in params.items()}
        return init_params(CFG, torch.Generator().manual_seed(seed))

    return Trainer(CFG, tcfg, ds, adamw(constant(2e-3)), init, device="cpu")


def _losses(log):
    return [m["loss"] for m in log if m["event"] == "step"]


# -- AsyncRefresher -------------------------------------------------------------


def test_refresher_snapshots_params_before_in_place_updates():
    gate = threading.Event()
    seen = []

    def work(p):
        gate.wait(10)
        seen.append(p["w"].clone())
        return 1

    r = AsyncRefresher(work, mode="async")
    live = {"w": torch.zeros(3)}
    r.submit(live)
    live["w"].add_(5.0)  # the optimizer's in-place update
    gate.set()
    r.wait(10)
    assert not r.busy
    torch.testing.assert_close(seen[0], torch.zeros(3))
    assert r.collect().value == 1


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_refresher_failure_policies(mode):
    calls = []

    def flaky(_):
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient")
        return "ok"

    r = AsyncRefresher(flaky, mode=mode,
                       failure_policy=FailurePolicy(max_retries=2, backoff_base_s=0.0))
    r.submit({})
    r.wait(10)
    res = r.collect()
    assert res.value == "ok" and res.attempts == 3

    failed = []
    r = AsyncRefresher(lambda _: 1 / 0, mode=mode, on_failure=failed.append,
                       failure_policy=FailurePolicy(on_exhaustion="keep_stale"))
    r.submit({})
    r.wait(10)
    assert len(failed) == 1 and r.last_failure is not None and r.collect() is None

    r = AsyncRefresher(lambda _: 1 / 0, mode=mode)
    if mode == "sync":
        with pytest.raises(RuntimeError, match="failed"):
            r.submit({})
    else:
        r.submit({})
        with pytest.raises(RuntimeError, match="failed"):
            r.wait(10)

    runs = []

    def once_bad(_):
        runs.append(threading.current_thread().name)
        if len(runs) == 1:
            raise ValueError("first")
        return "second"

    r = AsyncRefresher(once_bad, mode=mode,
                       failure_policy=FailurePolicy(on_exhaustion="sync_fallback"))
    r.submit({})
    r.wait(10)
    res = r.collect()
    assert res.value == "second" and res.fell_back
    with pytest.raises(RuntimeError, match="no ingest_fn"):  # the service passes one
        r.ingest([1])


# -- extraction ---------------------------------------------------------------


def test_extractor_matches_reference_and_per_batch(monkeypatch):
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg = JModelConfig(**SMALL)
    jp = ref_init(jcfg, 0)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    pool = np.arange(0, 40, 3)[:13]  # 13 rows: a wrapped tail batch
    jx = JProxyExtractor(jmake_select_step(jcfg, "einsum"),
                         JTokenStream(n_docs=40, seq_len=24, vocab_size=128), 4, megabatch=2)
    want = np.asarray(jx.extract(jp, pool))
    ds = TokenStream(n_docs=40, seq_len=24, vocab_size=128)
    for mb, pf in ((2, True), (1, False), (8, True)):
        tx = ProxyExtractor(make_select_step(CFG, "auto"), ds, 4, megabatch=mb, prefetch=pf)
        got = tx.extract(tp, pool)
        assert got.shape == (13, 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the data-parallel extract over a 2-shard CPU mesh is the same sweep
    mesh = compat_mesh((2,), ("data",), devices=["cpu"])
    got_mesh = ProxyExtractor(make_select_step(CFG, "auto"), ds, 4, megabatch=2,
                              mesh=mesh).extract(tp, pool)
    assert torch.equal(got_mesh, got)


# -- checkpointing --------------------------------------------------------------


def test_checkpoint_round_trip_and_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"params": {"a.b": torch.arange(6.0).reshape(2, 3), "c": torch.ones(2)},
            "opt": OptState(7, {"m": {"a.b": torch.full((2, 3), 0.5)}})}
    for step in (1, 2, 3):
        mgr.save(step, tree, {"step": step, "note": [1, 2]}, blocking=step != 3)
    mgr.wait()
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_")) == [
        "step_00000002", "step_00000003"]
    template = {"params": {"a.b": torch.zeros(2, 3), "c": torch.zeros(2)},
                "opt": OptState(0, {"m": {"a.b": torch.zeros(2, 3)}})}
    got, extras = mgr.restore(template)
    assert extras == {"step": 3, "note": [1, 2]}
    assert isinstance(got["opt"], OptState) and got["opt"].step == 7
    torch.testing.assert_close(got["params"]["a.b"], tree["params"]["a.b"])
    torch.testing.assert_close(got["opt"].inner["m"]["a.b"], tree["opt"].inner["m"]["a.b"])


# -- trainer ---------------------------------------------------------------------


def test_trainer_matches_reference_trainer(monkeypatch):
    """The first epoch trains on the full data and ends with the first
    selection (made from the initial parameters): losses to the train-step
    tolerance, and the selection under the tie rule of
    ``repro_torch.parity`` — the two packages' features differ by fp32
    rounding, so greedy picks may part only at a near-tie, after which the
    objectives must agree within 1e-3 (as slice 1 holds selections)."""
    from repro_torch import parity

    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg = JModelConfig(**SMALL)
    jp = ref_init(jcfg, 0)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    jt = JTrainer(
        jcfg,
        JTrainerConfig(batch_size=8, select_every_epochs=2, refresh_mode="sync",
                       craig=JCraigConfig(fraction=0.5, per_class=False)),
        JTokenStream(n_docs=48, seq_len=24, vocab_size=128, n_topics=6),
        jadamw(jconstant(2e-3)), lambda: jp,
    )
    tt = _trainer(None, params=tp, refresh_mode="sync")
    feats = tt.extractor.extract(tt.params, tt._pool_indices())  # the initial params
    jlog, tlog = jt.run(6), tt.run(6)
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), rtol=1e-4)
    js, ts = jt._prev_selection, tt._prev_selection
    assert ts.size == js.size == 24
    assert float(ts.weights.sum()) == float(js.weights.sum()) == 48
    assert tt.sampler.pending_version == jt.sampler.pending_version == 1
    t = parity.first_divergence(feats, list(ts.indices), list(js.indices),
                                parity.tie_tolerance(feats))
    if t is not None:
        ca, cb = parity.coverage64(feats, ts.indices), parity.coverage64(feats, js.indices)
        assert abs(ca - cb) <= 1e-3 * cb


def test_sync_and_async_refresh_give_the_same_steps():
    logs = {mode: _trainer(None, refresh_mode=mode).run(14) for mode in ("sync", "async")}
    assert _losses(logs["sync"]) == _losses(logs["async"])
    refreshes = [m for m in logs["async"] if m["event"] == "craig_refresh"]
    assert refreshes and refreshes[0]["coreset_size"] == 24
    assert refreshes[0]["engine"]["name"] == "matrix"


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_trainer_is_freed_without_a_garbage_collection(mode):
    # the refresher's callbacks must not hold the trainer (its parameters
    # and optimizer state) in a reference cycle
    trainer = _trainer(None, refresh_mode=mode)
    trainer.run(14)
    trainer.refresher.wait()
    assert trainer.refresher.version == 2
    ref = weakref.ref(trainer)
    gc.disable()
    try:
        del trainer
        assert ref() is None
    finally:
        gc.enable()


def test_preemption_saves_and_restart_resumes_step_for_step(tmp_path):
    full = _trainer(None).run(14)
    t1 = _trainer(tmp_path)
    t1.run(7)
    t1.request_preempt()
    t1.run(1)  # saves at this step boundary and stops
    saved = t1.step
    t2 = _trainer(tmp_path, seed=99)  # another init, overwritten by the restore
    assert t2.restore_or_init() and t2.step == saved
    for k in t1.params:
        torch.testing.assert_close(t2.params[k], t1.params[k], rtol=0, atol=0)
    rest = t2.run(14 - saved)
    assert _losses(full)[saved:] == _losses(rest)[-(14 - saved):]


class GrowingStream:
    """A corpus that grows between epochs: ``n_docs`` exposes a prefix of
    the inner stream, extended by :meth:`grow` (the reference's test
    defines the same; neither package has one)."""

    def __init__(self, inner, visible):
        self._inner = inner
        self.n_docs = int(visible)

    def batch(self, idx):
        return self._inner.batch(idx)

    def class_labels(self, idx):
        return self._inner.class_labels(idx)

    def grow(self, n):
        self.n_docs = min(self._inner.n_docs, self.n_docs + int(n))


def _stream_trainer(tmp=None, seed=0, params=None, **kw):
    ds = GrowingStream(TokenStream(n_docs=48, seq_len=24, vocab_size=128, n_topics=6), 24)
    tcfg = TrainerConfig(
        batch_size=8, select_every_epochs=1, refresh_mode=kw.pop("refresh_mode", "sync"),
        streaming_ingest=True, checkpoint_dir=str(tmp) if tmp else None,
        craig=CraigConfig(fraction=0.5, per_class=False), **kw,
    )

    def init():
        if params is not None:
            return {k: v.clone() for k, v in params.items()}
        return init_params(CFG, torch.Generator().manual_seed(seed))

    return ds, Trainer(CFG, tcfg, ds, adamw(constant(2e-3)), init, device="cpu")


@pytest.mark.parametrize("evict", [True, False])
def test_streaming_ingest_growing_corpus(evict):
    """Only the docs appended since the last boundary are extracted, the
    pool and its doc ids stay in lockstep with eviction, and installed
    coresets index the grown corpus."""
    ds, t = _stream_trainer(streaming_evict=evict)
    pool_sizes = []
    extract = t.extractor.extract
    t.extractor.extract = lambda p, idx: (pool_sizes.append(list(idx)), extract(p, idx))[1]
    t.run(4)  # boundary 0 ingests docs [0, 24); install at epoch 1
    assert t._stream_cursor == 24 and t._stream_sel.n_seen == 24
    assert t._stream_sel.budget == 12  # fraction × the first delta
    ds.grow(24)
    t.run(8)  # the next boundary ingests exactly the appended [24, 48)
    assert pool_sizes == [list(range(24)), list(range(24, 48))]
    assert t._stream_cursor == 48 and t._stream_sel.n_seen == 48
    refreshes = [m for m in t.metrics_log if m["event"] == "craig_refresh"]
    assert len(refreshes) >= 2
    assert all(r["coreset_size"] == 12 for r in refreshes)
    n_rows = t._stream_sel.n_rows
    assert t._stream_pool.shape == (n_rows, CFG.d_model)
    assert t._stream_doc_ids.shape == (n_rows,)
    assert n_rows < 48 if evict else n_rows == 48
    assert refreshes[-1]["n_live"] == n_rows and refreshes[-1]["n_seen"] == 48
    assert refreshes[-1]["engine"]["name"] == "streaming"
    idx = t.sampler._indices
    assert len(idx) == 12 == len(np.unique(idx)) and idx.min() >= 0 and idx.max() < 48
    assert set(idx) <= set(t._stream_doc_ids)
    np.testing.assert_allclose(np.sum(t.sampler._weights), n_rows)  # Σγ = live rows
    t.run(4)  # no new docs: boundaries are no-ops
    assert t.refresher.version == 2


def test_streaming_ingest_restart_resumes(tmp_path):
    """The cursor, the sieve states, the compacted pool (in the tensor
    tree) and the doc ids round-trip through the checkpoint; the restarted
    trainer continues the stream without re-ingesting."""
    _, t1 = _stream_trainer(tmp_path)
    t1.run(4)
    t1._save(blocking=True)
    ds2, t2 = _stream_trainer(tmp_path, seed=9)
    assert t2.restore_or_init()
    assert t2._stream_cursor == t1._stream_cursor == 24
    assert t2._stream_sel.n_seen == t1._stream_sel.n_seen
    np.testing.assert_array_equal(t2._stream_doc_ids, t1._stream_doc_ids)
    torch.testing.assert_close(t2._stream_pool, t1._stream_pool, rtol=0, atol=0)
    for a, b in zip(t2._stream_sel.state(), t1._stream_sel.state()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    extras = json.dumps(t2.ckpt.extras())
    assert "sel_feats" not in extras and "pool" not in extras  # tensors, not JSON lists
    ds2.grow(24)
    t2.run(6)
    assert t2._stream_cursor == 48 and t2._stream_sel.n_seen == 48
    # a checkpoint taken before the first drain restores an empty stream
    _, t3 = _stream_trainer(tmp_path / "early")
    t3._save(blocking=True)
    _, t4 = _stream_trainer(tmp_path / "early", seed=9)
    assert t4.restore_or_init() and t4._stream_sel is None and t4._stream_cursor == 0


def test_streaming_first_drain_matches_reference_trainer(monkeypatch):
    """From the same weights at fp32, the first drain's features agree to
    rtol 1e-4, and the sieve admits the same docs: doc ids and γ equal."""
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg = JModelConfig(**SMALL)
    jp = ref_init(jcfg, 0)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    jds = GrowingStream(JTokenStream(n_docs=48, seq_len=24, vocab_size=128, n_topics=6), 24)
    jt = JTrainer(jcfg, JTrainerConfig(batch_size=8, select_every_epochs=1, refresh_mode="sync",
                                       streaming_ingest=True,
                                       craig=JCraigConfig(fraction=0.5, per_class=False)),
                  jds, jadamw(jconstant(2e-3)), lambda: jp)
    _, tt = _stream_trainer(params=tp)
    jt.run(4), tt.run(4)  # the first drain installs at step 3
    np.testing.assert_allclose(tt._stream_pool.numpy(), jt._stream_pool, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tt._stream_doc_ids, jt._stream_doc_ids)
    assert tt.sampler.version == jt.sampler.version == 1
    np.testing.assert_array_equal(tt.sampler._indices, jt.sampler._indices)
    np.testing.assert_array_equal(tt.sampler._weights, jt.sampler._weights)


def test_example_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import lm_coreset_training as ex

    out = ex.main(["--device", "cpu", "--d-model", "32", "--layers", "2", "--vocab", "128",
                   "--seq", "12", "--docs", "24", "--batch", "4", "--steps", "9",
                   "--ckpt", str(tmp_path)])
    assert out["steps"] == 9 and out["refreshes"] >= 1
    assert np.isfinite(out["last_loss"])
    assert "CRAIG:" in capsys.readouterr().out
