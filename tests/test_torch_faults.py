"""Fault injection and supervised failure handling in the port.

The reference's ``tests/test_faults.py`` on the port's modules, minus its
tree parts (the distributed selection is not ported): the deterministic
``FaultPlan`` registry, ``FailurePolicy``, every exhaustion route through
``AsyncRefresher``, the NaN/Inf feature guard, the coreset service's
transactional ingest and its stdio protocol, the trainer's transient
refresh failures, and the streaming trainer's transactional drain.  A plan
the reference serialises must load in the port and fire on the same calls.
Everything runs on the CPU; exact comparisons throughout (the trainer's
healed run is bit-identical to a clean one: the same arithmetic in the
same order).
"""
import io
import json
import time

import numpy as np
import pytest
import torch

import repro.faults as jfaults
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.core.extract import ProxyExtractor
from repro_torch.core.refresh import AsyncRefresher
from repro_torch.data.synthetic import TokenStream
from repro_torch.faults import (
    ENV_VAR,
    FailurePolicy,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    active_plan,
    clear,
    fault_point,
    fault_value,
    injected,
    install_from_env,
)
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, constant
from repro_torch.serve import CoresetService
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.train_step import make_select_step
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=64, vocab_size=128, logit_chunk=16)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    clear()
    jfaults.clear()


# -- FaultPlan / FaultSpec -------------------------------------------------------


def test_fault_spec_validates_fields():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(site="x", kind="explode")
    with pytest.raises(ValueError, match="1-based"):
        FaultSpec(site="x", kind="raise", on_calls=(0,))
    with pytest.raises(ValueError, match="every"):
        FaultSpec(site="x", kind="raise", every=0)
    with pytest.raises(ValueError, match="p="):
        FaultSpec(site="x", kind="raise", p=1.5)


def test_on_calls_fires_on_exact_call_numbers():
    plan = FaultPlan([FaultSpec(site="s", kind="raise", on_calls=(2,))])
    with injected(plan):
        fault_point("s")  # call 1: quiet
        with pytest.raises(FaultInjected, match="call 2"):
            fault_point("s")
        fault_point("s")  # call 3: quiet
    assert plan.calls("s") == 3


def test_every_pattern_fires_on_first_of_each_period():
    plan = FaultPlan([FaultSpec(site="s", kind="raise", every=2)])
    fired = []
    with injected(plan):
        for _ in range(4):
            try:
                fault_point("s")
                fired.append(False)
            except FaultInjected:
                fired.append(True)
    assert fired == [True, False, True, False]


def _fired(plan, hooks, site="s", **ctx):
    """Drive ``site`` 40 times through a package's hooks: 1 where it raised."""
    out = []
    with hooks.injected(plan):
        for _ in range(40):
            try:
                hooks.fault_point(site, **ctx)
                out.append(0)
            except hooks.FaultInjected:
                out.append(1)
    return out


def test_probabilistic_firing_is_seed_deterministic():
    import repro_torch.faults as tfaults

    def seq(seed):
        return _fired(FaultPlan([FaultSpec(site="s", kind="raise", p=0.5)], seed=seed), tfaults)

    assert seq(7) == seq(7)
    assert 0 < sum(seq(7)) < 40  # actually probabilistic, not constant


@pytest.mark.parametrize("spec", [
    {"site": "s", "kind": "raise", "on_calls": [2, 5, 33]},
    {"site": "s", "kind": "raise", "every": 3},
    {"site": "s", "kind": "raise", "p": 0.3},
    {"site": "s", "kind": "drop_key", "key_pattern": "sizes"},
])
def test_reference_plan_fires_identically_in_the_port(spec):
    """A plan serialised by ``repro.faults`` loads in the port (the same
    JSON) and fires on the same calls, the seeded ``p`` draws included."""
    import repro_torch.faults as tfaults

    ref = jfaults.FaultPlan([jfaults.FaultSpec.from_dict(spec)], seed=11)
    port = FaultPlan.from_json(ref.to_json())
    assert port.to_dict() == ref.to_dict()
    for key in ("tree/0/sizes", "tree/0/n"):
        want = _fired(jfaults.FaultPlan.from_json(ref.to_json()), jfaults, key=key)
        got = _fired(FaultPlan.from_json(ref.to_json()), tfaults, key=key)
        assert got == want
    assert sum(want) < 40 or spec["kind"] == "drop_key"


def test_plan_json_roundtrip_and_env_install(monkeypatch):
    plan = FaultPlan([FaultSpec(site="kv.get", kind="drop_key", key_pattern="sizes")], seed=3)
    monkeypatch.setenv(ENV_VAR, plan.to_json())
    assert ENV_VAR == jfaults.ENV_VAR == "REPRO_FAULT_PLAN"
    installed = install_from_env()
    assert installed is active_plan()
    assert installed.seed == 3
    assert installed.specs == plan.specs
    monkeypatch.delenv(ENV_VAR)
    assert install_from_env() is None  # unset env: no-op, plan untouched
    assert active_plan() is installed


def test_drop_key_respects_key_pattern():
    plan = FaultPlan([FaultSpec(site="kv.get", kind="drop_key", key_pattern="sizes")])
    with injected(plan):
        fault_point("kv.get", key="tree/0/n/1")  # no match: quiet
        with pytest.raises(FaultInjected, match="tree/0/sizes"):
            fault_point("kv.get", key="tree/0/sizes")


def test_latency_fault_sleeps():
    plan = FaultPlan([FaultSpec(site="s", kind="latency", latency_s=0.05)])
    with injected(plan):
        t0 = time.monotonic()
        fault_point("s")
        assert time.monotonic() - t0 >= 0.04


def test_nan_fault_corrupts_leading_rows_preserving_array_family():
    plan = FaultPlan([FaultSpec(site="v", kind="nan", rows=2)])
    feats = np.ones((4, 3), np.float32)
    with injected(plan):
        out = plan.apply("v", feats)
        assert isinstance(out, np.ndarray)
        assert np.isnan(out[:2]).all() and np.isfinite(out[2:]).all()
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.ones((4, 3), dtype=dtype)
            tout = fault_value("v", t)
            assert isinstance(tout, torch.Tensor) and tout is not t
            assert tout.dtype == dtype and tout.device == t.device
            assert bool(torch.isnan(tout[:2]).all()) and bool(torch.isfinite(tout[2:]).all())
            assert bool(torch.isfinite(t).all())  # the input is not written into
    same = fault_value("v", feats)  # no plan installed → identity
    assert same is feats


# -- FailurePolicy -----------------------------------------------------------------


def test_failure_policy_validates():
    with pytest.raises(ValueError, match="max_retries"):
        FailurePolicy(max_retries=-1)
    with pytest.raises(ValueError, match="backoff"):
        FailurePolicy(backoff_base_s=-0.1)
    with pytest.raises(ValueError, match="on_exhaustion"):
        FailurePolicy(on_exhaustion="shrug")


def test_backoff_doubles_and_caps():
    p = FailurePolicy(max_retries=4, backoff_base_s=0.05, backoff_cap_s=0.15)
    assert p.backoff_s(0) == pytest.approx(0.05)
    assert p.backoff_s(1) == pytest.approx(0.10)
    assert p.backoff_s(2) == pytest.approx(0.15)  # capped
    assert p.backoff_s(3) == pytest.approx(0.15)


# -- AsyncRefresher supervision: every exhaustion route ---------------------------


def _flaky(fail_first_n):
    """Work fn failing its first ``fail_first_n`` calls, succeeding after."""
    calls = {"n": 0}

    def work(_params):
        calls["n"] += 1
        if calls["n"] <= fail_first_n:
            raise RuntimeError(f"transient #{calls['n']}")
        return f"ok@{calls['n']}"

    return work, calls


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_retry_recovers_and_records_attempts(mode):
    work, calls = _flaky(1)
    r = AsyncRefresher(work, mode=mode,
                       failure_policy=FailurePolicy(max_retries=1, backoff_base_s=0.0))
    r.submit(None)
    res = r.collect(block=True)
    assert res.attempts == 2 and not res.fell_back
    assert res.value == "ok@2" and res.error is None
    assert calls["n"] == 2


def test_exhaustion_raise_surfaces_once_and_does_not_poison():
    work, calls = _flaky(2)
    r = AsyncRefresher(work, mode="async",
                       failure_policy=FailurePolicy(max_retries=1, backoff_base_s=0.0))
    r.submit(None)
    with pytest.raises(RuntimeError, match=r"v1 failed after 2 attempt"):
        r.wait()
    r.wait()  # consumed: exactly-once surfacing
    r.submit(None)  # failure is per job, not per refresher
    res = r.collect(block=True)
    assert res.value == "ok@3" and res.attempts == 1


def test_keep_stale_abandons_logs_once_and_stays_usable():
    work, calls = _flaky(1)
    failures = []
    r = AsyncRefresher(work, mode="async",
                       failure_policy=FailurePolicy(on_exhaustion="keep_stale"),
                       on_failure=failures.append)
    r.submit(None)
    r.wait()  # does not raise: the job was abandoned
    assert len(failures) == 1
    assert failures[0].version == 1 and failures[0].attempts == 1
    assert "transient" in str(failures[0].error)
    assert r.last_failure is failures[0]
    assert r.collect() is None
    r.submit(None)
    assert r.collect(block=True).value == "ok@2"
    assert len(failures) == 1


def test_sync_fallback_reruns_inline_at_next_touch_point():
    work, calls = _flaky(2)
    r = AsyncRefresher(work, mode="async", failure_policy=FailurePolicy(
        max_retries=1, backoff_base_s=0.0, on_exhaustion="sync_fallback"))
    r.submit(None)
    res = r.collect(block=True)  # wait() runs the fallback on this thread
    assert res.fell_back and res.attempts == 3
    assert res.value == "ok@3" and res.error is None


def test_sync_fallback_second_failure_raises():
    work, calls = _flaky(10)
    r = AsyncRefresher(work, mode="async", failure_policy=FailurePolicy(
        max_retries=0, backoff_base_s=0.0, on_exhaustion="sync_fallback"))
    r.submit(None)
    with pytest.raises(RuntimeError, match=r"v1 failed after 2 attempt"):
        r.wait()
    r.wait()


def test_publish_failure_is_never_retried():
    work, calls = _flaky(0)

    def bad_publish(_res):
        raise RuntimeError("stage exploded")

    r = AsyncRefresher(work, mode="async", on_complete=bad_publish,
                       failure_policy=FailurePolicy(max_retries=3, backoff_base_s=0.0,
                                                    on_exhaustion="sync_fallback"))
    r.submit(None)
    with pytest.raises(RuntimeError, match="failed after 1 attempt"):
        r.wait()
    assert calls["n"] == 1  # a re-run could stage the same version twice


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_injected_refresh_fault_rides_the_policy(mode):
    """The refresh.worker hook sits inside the retry loop: a plan that
    fails every first attempt is healed by max_retries=1."""
    plan = FaultPlan([FaultSpec(site="refresh.worker", kind="raise", every=2)])
    r = AsyncRefresher(lambda p: "selected", mode=mode,
                       failure_policy=FailurePolicy(max_retries=1, backoff_base_s=0.0))
    with injected(plan):
        r.submit(None)
        res = r.collect(block=True)
        assert res.attempts == 2 and res.value == "selected"
    assert plan.calls("refresh.worker") == 2


# -- validate_features guard (selector path) ---------------------------------------


def _pool_with_bad_rows(n=64, d=8, bad=(3, 7)):
    feats = np.random.RandomState(0).randn(n, d).astype(np.float32)
    feats[bad[0], 0] = np.nan
    feats[bad[1], 1] = np.inf
    return feats


def test_validate_features_raise_names_rows():
    sel = CraigSelector(CraigConfig(fraction=0.25, per_class=False), device="cpu")
    with pytest.raises(ValueError, match=r"2 of 64 .* \[3, 7\]"):
        sel.select(_pool_with_bad_rows())


def test_validate_features_drop_warns_remaps_and_counts():
    sel = CraigSelector(CraigConfig(fraction=0.25, per_class=False, validate_features="drop"),
                        device="cpu")
    with pytest.warns(UserWarning, match="dropping 2"):
        cs = sel.select(_pool_with_bad_rows())
    assert cs.n_dropped == 2
    assert 3 not in cs.indices and 7 not in cs.indices
    assert cs.indices.max() < 64
    assert float(np.sum(cs.weights)) == pytest.approx(62.0)


def test_validate_features_off_passes_through():
    sel = CraigSelector(CraigConfig(fraction=0.25, per_class=False, validate_features="off"),
                        device="cpu")
    cs = sel.select(_pool_with_bad_rows())
    assert cs.n_dropped == 0 and len(cs.indices) == 16


def test_extract_nan_injection_is_caught_by_the_guard():
    """The extract.features seam: a nan fault on ``ProxyExtractor.extract``
    gives exactly the corruption validate_features exists to catch."""
    ds = TokenStream(n_docs=32, seq_len=8, vocab_size=128)
    params = init_params(CFG, torch.Generator().manual_seed(0))
    ex = ProxyExtractor(make_select_step(CFG), ds, 8, megabatch=2)
    plan = FaultPlan([FaultSpec(site="extract.features", kind="nan", rows=4)])
    with injected(plan):
        corrupted = ex.extract(params, np.arange(32))
    assert plan.calls("extract.features") == 1
    assert isinstance(corrupted, torch.Tensor) and corrupted.shape == (32, 32)
    assert bool(torch.isnan(corrupted[:4]).all()) and bool(torch.isfinite(corrupted[4:]).all())
    sel = CraigSelector(CraigConfig(fraction=0.25, per_class=False), device="cpu")
    with pytest.raises(ValueError, match="4 of 32"):
        sel.select(corrupted)


# -- CoresetService: transactional ingest and keep_stale replies --------------------


def _delta(seed, n=16, d=4):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def test_service_ingest_failure_is_atomic_and_recoverable():
    svc = CoresetService(8, 4, mode="sync", device="cpu")
    plan = FaultPlan([FaultSpec(site="service.ingest", kind="raise", on_calls=(2,))])
    with injected(plan):
        svc.submit_delta(_delta(0))
        assert svc.n_seen == 16
        with pytest.raises(RuntimeError, match="failed after 1 attempt"):
            svc.submit_delta(_delta(1))
        assert svc.n_seen == 16  # the poisoned drain rolled back
        svc.submit_delta(_delta(2))
    assert svc.n_seen == 32
    u = svc.coreset()
    assert u is not None and u.n_seen == 32 and len(u.indices) == 8


def test_service_keep_stale_records_failure_and_serves_stale():
    svc = CoresetService(8, 4, mode="sync", device="cpu",
                         failure_policy=FailurePolicy(on_exhaustion="keep_stale"))
    plan = FaultPlan([FaultSpec(site="service.ingest", kind="raise", on_calls=(2,))])
    with injected(plan):
        v1 = svc.submit_delta(_delta(0))
        assert svc.pop_failure() is None
        u1 = svc.coreset()
        svc.submit_delta(_delta(1))  # abandoned, no raise
        failure = svc.pop_failure()
        assert failure is not None and failure["event"] == "craig_refresh_failed"
        assert failure["attempts"] == 1 and "injected" in failure["error"]
        assert svc.pop_failure() is None
        assert svc.n_seen == 16
        assert svc.coreset().version == u1.version == v1
        svc.submit_delta(_delta(2))
    assert svc.n_seen == 32 and svc.coreset().n_seen == 32


def test_serve_loop_arms_the_plan_from_the_environment(monkeypatch):
    """launch/serve.py installs $REPRO_FAULT_PLAN (written by the
    reference's package here) and surfaces the keep_stale abandonment as an
    ok=false reply with the craig_refresh_failed event, then keeps serving."""
    from repro_torch.launch.serve import _serve_coreset

    plan = jfaults.FaultPlan([jfaults.FaultSpec(site="service.ingest", kind="raise",
                                                on_calls=(2,))])
    monkeypatch.setenv(ENV_VAR, plan.to_json())

    class Args:
        budget, dim, metric, per_class = 8, 4, "l2", False
        eps, levels, evict = 0.15, 0, False
        ingest_retries, ingest_backoff_s = 0, 0.0
        on_exhaustion = "keep_stale"
        device = "cpu"

    reqs = [{"op": "delta", "feats": _delta(0).tolist()},
            {"op": "delta", "feats": _delta(1).tolist()},
            {"op": "coreset"}, {"op": "quit"}]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()
    _serve_coreset(Args(), stdin=stdin, stdout=stdout)
    r1, r2, r3, r4 = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert r1["ok"] is True and r1["version"] == 1
    assert r2["ok"] is False and r2["event"] == "craig_refresh_failed"
    assert r2["n_seen"] == 16
    assert r3["ok"] is True and r3["version"] == 1
    assert r4 == {"ok": True, "bye": True}
    assert active_plan().calls("service.ingest") == 2


# -- Trainer: transient failures heal bit-identically; keep_stale degrades ----------


def _train(n_steps=14, policy=None, **kw):
    ds = TokenStream(n_docs=48, seq_len=24, vocab_size=128, n_topics=6)
    tcfg = TrainerConfig(batch_size=8, select_every_epochs=2, refresh_mode="sync",
                         craig=CraigConfig(fraction=0.5, per_class=False),
                         refresh_failure_policy=policy, **kw)
    t = Trainer(CFG, tcfg, ds, adamw(constant(2e-3)),
                lambda: init_params(CFG, torch.Generator().manual_seed(0)), device="cpu")
    return t.run(n_steps)


def _losses(log):
    return [m["loss"] for m in log if m["event"] == "step"]


def test_trainer_transient_refresh_failure_trains_bit_identically():
    clean = _train()
    plan = FaultPlan([FaultSpec(site="refresh.worker", kind="raise", every=2)])
    with injected(plan):
        healed = _train(policy=FailurePolicy(max_retries=1, backoff_base_s=0.0,
                                             on_exhaustion="keep_stale"))
    assert _losses(clean) == _losses(healed)  # bit-identical, not approx
    assert [m for m in healed if m["event"] == "craig_refresh"]
    assert not [m for m in healed if m["event"] == "craig_refresh_failed"]


def test_trainer_keep_stale_logs_failures_and_completes():
    plan = FaultPlan([FaultSpec(site="refresh.worker", kind="raise")])
    with injected(plan):
        log = _train(policy=FailurePolicy(on_exhaustion="keep_stale"))
    assert len([m for m in log if m["event"] == "step"]) == 14
    failed = [m for m in log if m["event"] == "craig_refresh_failed"]
    assert failed and failed[0]["attempts"] == 1
    assert "FaultInjected" in failed[0]["error"]
    assert not [m for m in log if m["event"] == "craig_refresh"]


class _Growing:
    """A corpus whose visible prefix grows (tests/test_torch_lm_trainer.py)."""

    def __init__(self, inner, visible):
        self._inner, self.n_docs = inner, int(visible)

    def batch(self, idx):
        return self._inner.batch(idx)

    def grow(self, n):
        self.n_docs = min(self._inner.n_docs, self.n_docs + int(n))


def _stream_run(plan=None, fail_finalize_once=False):
    ds = _Growing(TokenStream(n_docs=48, seq_len=24, vocab_size=128, n_topics=6), 24)
    tcfg = TrainerConfig(batch_size=8, select_every_epochs=1, refresh_mode="sync",
                         streaming_ingest=True, craig=CraigConfig(fraction=0.5, per_class=False),
                         refresh_failure_policy=FailurePolicy(max_retries=1, backoff_base_s=0.0))
    t = Trainer(CFG, tcfg, ds, adamw(constant(2e-3)),
                lambda: init_params(CFG, torch.Generator().manual_seed(0)), device="cpu")
    t.run(4)  # the first drain installs at step 3
    if fail_finalize_once:
        sel, result = t._stream_sel, t._stream_sel.result

        def once(*a):  # the drain fails after it ingested and compacted
            sel.result = result
            raise RuntimeError("finalize failed")

        sel.result = once
    ds.grow(24)
    with injected(plan or FaultPlan([])):
        t.run(8)
    return t


def test_streaming_drain_is_transactional_under_retries():
    """A drain that fails after ingesting, or at the refresh.worker hook,
    retries from the state before it: the same pool, doc ids, sieve state
    and installed coreset as a clean run."""
    clean = _stream_run()
    plan = FaultPlan([FaultSpec(site="refresh.worker", kind="raise", on_calls=(1,))])
    for t in (_stream_run(plan=plan), _stream_run(fail_finalize_once=True)):
        assert t._stream_sel.n_seen == clean._stream_sel.n_seen == 48
        np.testing.assert_array_equal(t._stream_doc_ids, clean._stream_doc_ids)
        torch.testing.assert_close(t._stream_pool, clean._stream_pool, rtol=0, atol=0)
        np.testing.assert_array_equal(t.sampler._indices, clean.sampler._indices)
        np.testing.assert_array_equal(t.sampler._weights, clean.sampler._weights)
        assert _losses(t.metrics_log) == _losses(clean.metrics_log)
    assert plan.calls("refresh.worker") == 2
