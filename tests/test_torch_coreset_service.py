"""The port's coreset service (repro_torch.serve) against the JAX reference.

The same numpy deltas go to both packages' ``CoresetService``; the port's
runs on the CPU here (``chip_smoke.py`` drives it on the card, through the
``fl_replay`` kernel).  Published selections must agree exactly: the
small pools below have no near-ties, so indices and γ are equal (the
finalize parity and its tolerances are in tests/test_torch_streaming.py).
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.serve import CoresetService as JService
from repro_torch.faults import FailurePolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import CoresetService
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

REPO = Path(__file__).resolve().parent.parent


def _deltas(n_deltas, rows, dim, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(rows, dim).astype(np.float32) for _ in range(n_deltas)]


def _assert_same_update(u, ju):
    assert (u.version, u.n_seen, u.n_live) == (ju.version, ju.n_seen, ju.n_live)
    np.testing.assert_array_equal(u.indices, ju.indices)
    np.testing.assert_array_equal(u.weights, ju.weights)
    np.testing.assert_allclose(u.coverage, ju.coverage, rtol=1e-4)


def test_service_versions_and_double_buffer():
    deltas = _deltas(3, 20, 4, seed=1)
    svc = CoresetService(6, 4, device="cpu")
    jsvc = JService(6, 4)
    assert svc.coreset() is None and svc.version == 0
    for i, d in enumerate(deltas):
        assert svc.submit_delta(d) == jsvc.submit_delta(d) == i + 1
        assert svc.version == 0  # staged, not installed
    u, ju = svc.coreset(), jsvc.coreset()
    assert svc.version == 3 and u.n_seen == 60
    assert u.weights.sum() == pytest.approx(60.0) and len(set(u.indices)) == 6
    _assert_same_update(u, ju)
    assert svc.coreset() is u  # nothing new staged: the installed one again


def test_service_async_coalesces_queued_deltas():
    deltas = _deltas(4, 16, 3, seed=7)
    svc = CoresetService(8, 3, mode="async", device="cpu")
    gate, entered = threading.Event(), threading.Event()
    ingest = svc.selector.ingest

    def held(*a, **k):  # the first drain waits until the test lets it go
        entered.set()
        assert gate.wait(60)
        return ingest(*a, **k)

    svc.selector.ingest = held
    assert svc.submit_delta(deltas[0]) == 1
    assert entered.wait(60)
    assert [svc.submit_delta(d) for d in deltas[1:]] == [None, None, None]
    assert svc.refresher.pending_deltas == 3
    svc.selector.ingest = ingest
    gate.set()
    u = svc.coreset(block=True)
    assert u.version == 2 and u.n_seen == 64  # one drain of 1, one of 3
    assert svc.refresher.pending_deltas == 0
    jsvc = JService(8, 3)
    for d in deltas:
        jsvc.submit_delta(d)
    ju = jsvc.coreset()
    np.testing.assert_array_equal(u.indices, ju.indices)
    np.testing.assert_array_equal(u.weights, ju.weights)


def test_service_keep_stale_serves_the_installed_selection():
    deltas = _deltas(3, 20, 3, seed=3)
    svc = CoresetService(5, 3, device="cpu",
                         failure_policy=FailurePolicy(max_retries=1, backoff_base_s=0.0,
                                                      on_exhaustion="keep_stale"))
    svc.submit_delta(deltas[0])
    first = svc.coreset()
    ingest, calls = svc.selector.ingest, []

    def broken(*a, **k):
        calls.append(1)
        raise OSError("injected")

    svc.selector.ingest = broken
    svc.submit_delta(deltas[1])
    failure = svc.pop_failure()
    assert failure["event"] == "craig_refresh_failed" and failure["attempts"] == 2
    assert "injected" in failure["error"] and len(calls) == 2
    assert svc.pop_failure() is None
    assert svc.coreset() is first and svc.n_seen == 20  # rolled back
    svc.selector.ingest = ingest
    assert svc.submit_delta(deltas[2]) == 3
    u = svc.coreset()
    assert u.n_seen == 40 and u.weights.sum() == pytest.approx(40.0)
    jsvc = JService(5, 3)
    jsvc.submit_delta(deltas[0])
    jsvc.submit_delta(deltas[2])
    np.testing.assert_array_equal(u.indices, jsvc.coreset().indices)


def test_service_worker_failure_surfaces():
    svc = CoresetService(6, 2, per_class=True, device="cpu")
    with pytest.raises(RuntimeError, match="failed"):
        svc.submit_delta(np.zeros((10, 2), np.float32))  # per_class, no labels
    with pytest.raises(ValueError, match=r"\(Δn, 2\)"):
        svc.submit_delta(np.zeros((5, 3), np.float32))


@pytest.mark.parametrize("evict", [False, True])
def test_service_state_dict_resume(evict):
    deltas = _deltas(4, 40, 3, seed=8)
    a = CoresetService(7, 3, evict=evict, device="cpu")
    for d in deltas:
        a.submit_delta(d)
    b = CoresetService(7, 3, evict=evict, device="cpu")
    for d in deltas[:2]:
        b.submit_delta(d)
    b.coreset()
    snap = json.loads(json.dumps(b.state_dict()))
    c = CoresetService(7, 3, evict=evict, device="cpu")
    c.load_state_dict(snap)
    assert c.version == b.version == 2
    assert c.state_dict() == snap
    for d in deltas[2:]:
        c.submit_delta(d)
    ua, uc = a.coreset(), c.coreset()
    assert (ua.version, ua.n_seen, ua.n_live) == (uc.version, uc.n_seen, uc.n_live)
    np.testing.assert_array_equal(ua.indices, uc.indices)
    np.testing.assert_array_equal(ua.weights, uc.weights)
    assert ua.coverage == uc.coverage
    if evict:
        assert ua.n_live < 160 and ua.weights.sum() == pytest.approx(ua.n_live)


@pytest.mark.parametrize("evict,per_class", [(False, False), (True, False), (False, True)])
def test_reference_service_state_resumes_in_the_port(evict, per_class):
    deltas = _deltas(4, 30, 3, seed=9)
    labels = [np.arange(30) % 2 for _ in deltas] if per_class else [None] * 4
    jsvc = JService(6, 3, evict=evict, per_class=per_class)
    for d, y in zip(deltas[:2], labels):
        jsvc.submit_delta(d, y)
    jsvc.coreset()
    svc = CoresetService(6, 3, evict=evict, per_class=per_class, device="cpu")
    svc.load_state_dict(json.loads(json.dumps(jsvc.state_dict())))
    assert svc.version == 2 and svc.n_seen == 60
    for d, y in zip(deltas[2:], labels[2:]):
        jsvc.submit_delta(d, y)
        svc.submit_delta(d, y)
    _assert_same_update(svc.coreset(), jsvc.coreset())


def test_decode_mode_runs():
    out = launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                             "--batch", "1", "--prompt-len", "3", "--new", "2"])
    assert tuple(out.shape) == (1, 5)


def test_coreset_service_subprocess_round_trip():
    """``python -m repro_torch.launch.serve --coreset`` over real pipes."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    rng = np.random.RandomState(9)
    reqs = [
        {"op": "delta", "feats": rng.randn(24, 4).tolist()},
        {"op": "delta", "feats": rng.randn(16, 4).tolist()},
        {"op": "coreset"},
        {"op": "bogus"},
        {"op": "quit"},
    ]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--coreset",
         "--budget", "6", "--dim", "4", "--device", "cpu"],
        input="\n".join(json.dumps(r) for r in reqs) + "\n",
        env=env, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    resp = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    assert len(resp) == 5
    assert resp[0] == {"ok": True, "version": 1, "n_seen": 24}
    assert resp[1] == {"ok": True, "version": 2, "n_seen": 40}
    sel = resp[2]
    assert sel["ok"] and sel["version"] == 2 and sel["n_seen"] == 40
    assert len(sel["indices"]) == 6 == len(set(sel["indices"]))
    assert sum(sel["gamma"]) == pytest.approx(40.0)
    assert resp[3]["ok"] is False and "bogus" in resp[3]["error"]
    assert resp[4] == {"ok": True, "bye": True}
    # the same requests in the reference's service give the same coreset
    jsvc = JService(6, 4)
    for r in reqs[:2]:
        jsvc.submit_delta(np.asarray(r["feats"], np.float32))
    ju = jsvc.coreset()
    assert sel["indices"] == ju.indices.tolist()
    assert sel["gamma"] == ju.weights.tolist()
