"""Sieve streaming in the port (repro_torch) against the JAX reference.

Both packages get the same numpy deltas.  On the CPU the port's finalize
runs the plain twin of ``fl_replay`` (``chip_smoke.py`` holds the CUDA
kernel to it on the card); the reference runs its jnp twin, its Pallas
kernel in interpret mode, or its dense ``streaming_result``.

Tolerances.  Ingest: the admission decisions, hence ``count``, ``lvl``,
``sel_idx`` and ``sel_feats``, must be equal; ``fval``, ``m`` and
``d_max`` are fp32 sums over the delta in another order, rtol 1e-5.
Finalize: indices and γ equal; gains within rtol 1e-3 plus atol τ₄ =
4·√ε₃₂·max‖x‖ (each candidate's gain holds its own self-similarity, whose
rounding differs between dot orders; the reference's blocked twin is
4.8e-4 off its dense path, ROADMAP queue 3); coverage rtol 1e-4 plus
budget·τ₄.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as JE
from repro.core.engines import streaming as JS
from repro.kernels import ops as jops
from repro_torch.convert import engine_config_from_reference
from repro_torch.core import engines as E
from repro_torch.core.engines import streaming as S
from repro_torch.kernels import fl_gains as kfl
from repro_torch.kernels import ops, ref
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

EPS32 = float(np.finfo(np.float32).eps)


def _tau(x):
    return 4.0 * np.sqrt(EPS32) * float(np.linalg.norm(x, axis=1).max())


def _clusters(n, d, n_clusters, seed, spread=0.6):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, d).astype(np.float32) * 6.0
    labels = np.arange(n) % n_clusters
    feats = centers[labels] + spread * rng.randn(n, d).astype(np.float32)
    return feats.astype(np.float32), labels


def _states(feats, budget, chunk, prefix=None, eps=0.15):
    """The same deltas through both packages' functional core."""
    pre_f = None if prefix is None else feats[np.asarray(prefix)]
    js = JS.init_streaming_state(budget, feats.shape[1], eps=eps, init_selected=prefix,
                                 init_feats=pre_f)
    ps = S.init_streaming_state(budget, feats.shape[1], eps=eps, init_selected=prefix,
                                init_feats=pre_f, device="cpu")
    for lo in range(0, len(feats), chunk):
        hi = min(lo + chunk, len(feats))
        idx = np.arange(lo, hi, dtype=np.int32)
        js = JS.ingest_delta(js, jnp.asarray(feats[lo:hi]), jnp.asarray(idx), eps)
        ps = S.ingest_delta(ps, feats[lo:hi], idx, eps)
    return js, ps


def assert_same_state(js, ps):
    for name in ("n_seen", "count", "lvl", "sel_idx", "sel_feats", "pre_idx", "pre_feats"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("fval", "fval_pre", "m", "d_max"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-5, err_msg=name)


def assert_same_result(x, got, want, budget):
    tau = _tau(x)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_allclose(got.gains.numpy(), np.asarray(want.gains), rtol=1e-3, atol=tau)
    np.testing.assert_allclose(float(got.coverage), float(want.coverage), rtol=1e-4,
                               atol=budget * tau)


@pytest.mark.parametrize("prefix", [None, [3, 17]])
def test_single_delta_ingest_matches_reference(prefix):
    feats, _ = _clusters(120, 5, 10, seed=1)
    js, ps = _states(feats, 14, chunk=120, prefix=prefix)
    assert_same_state(js, ps)
    assert int(ps.count.max()) > 0


@pytest.mark.parametrize("chunk", [16, 30, 47])
def test_multi_delta_ingest_matches_reference(chunk):
    feats, _ = _clusters(150, 6, 12, seed=2)
    js, ps = _states(feats, 12, chunk=chunk)
    assert_same_state(js, ps)


def test_init_streaming_state_defaults_to_the_card(monkeypatch):
    """The functional core's entry runs on the card unless the caller asks
    for the CPU: without CUDA the default raises with the hint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.init_streaming_state(6, 4)
    st = S.init_streaming_state(6, 4, device="cpu")
    assert all(t.device.type == "cpu" for t in st)
    assert st.capacity == 6 and st.sel_feats.shape[-1] == 4


def test_ingest_does_not_write_into_the_state_it_is_given():
    feats, _ = _clusters(80, 4, 8, seed=3)
    st = S.init_streaming_state(6, 4, device="cpu")
    st = S.ingest_delta(st, feats[:40], np.arange(40, dtype=np.int32), 0.15)
    before = [t.clone() for t in st]
    S.ingest_delta(st, feats[40:], np.arange(40, 80, dtype=np.int32), 0.15)
    for a, b in zip(st, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prefix", [None, [3, 17]])
def test_blocked_finalize_matches_dense(prefix):
    rng = np.random.RandomState(11)
    feats = rng.randn(120, 5).astype(np.float32)
    js, ps = _states(feats, 14, chunk=40, prefix=prefix)
    x = torch.as_tensor(feats)
    dense = S.streaming_result(ps, x, 14)
    blocked = S.streaming_result_blocked(ps, x, 14, impl="torch", block_m=8)
    assert_same_result(feats, blocked, dense, 14)
    # both against the reference's dense finalize
    want = JS.streaming_result(js, jnp.asarray(feats), 14)
    assert_same_result(feats, dense, want, 14)
    assert_same_result(feats, blocked, want, 14)
    assert_same_result(feats, S.streaming_result_blocked(ps, x, 14, impl="dense"), want, 14)


def test_blocked_finalize_backfill_parity():
    rng = np.random.RandomState(12)
    feats = rng.randn(60, 4).astype(np.float32)
    js, ps = _states(feats, 6, chunk=40)  # sieve capacity 6 < finalize budget 10
    best = int(torch.argmax(ps.fval))
    assert int(ps.count[best]) < 10  # backfill actually exercised
    x = torch.as_tensor(feats)
    got = S.streaming_result_blocked(ps, x, 10)
    assert_same_result(feats, got, S.streaming_result(ps, x, 10), 10)
    assert_same_result(feats, got, JS.streaming_result(js, jnp.asarray(feats), 10), 10)


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (37, 5, 3), (130, 129, 22), (300, 77, 33)])
def test_fl_replay_twin_matches_reference(n, m, d):
    rng = np.random.default_rng(n * m + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    e = x[rng.permutation(n)[:m]] if m <= n else rng.normal(size=(m, d)).astype(np.float32)
    valid = rng.random(m) < 0.8
    valid[0] = True
    cur0 = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    d_max = float(2.0 * np.sqrt((x * x).sum(1).max()) + 1e-6)
    tau = _tau(x)
    got = ops.fl_replay(torch.as_tensor(x), torch.as_tensor(e), torch.as_tensor(valid),
                        torch.as_tensor(cur0), d_max, block_m=16)
    for want in (jops.fl_replay(jnp.asarray(x), jnp.asarray(e), jnp.asarray(valid),
                                jnp.asarray(cur0), d_max),
                 ref.fl_replay_ref(torch.as_tensor(x), torch.as_tensor(e),
                                   torch.as_tensor(valid), torch.as_tensor(cur0), d_max)):
        g, cur, bv, bi = (np.asarray(a) for a in want)
        np.testing.assert_allclose(got[0].numpy(), g, rtol=1e-3, atol=tau)
        np.testing.assert_allclose(got[1].numpy(), cur, rtol=1e-5, atol=tau)
        np.testing.assert_allclose(got[2].numpy(), bv, rtol=1e-5, atol=tau)
        np.testing.assert_array_equal(got[3].numpy(), bi)
    assert got[3].dtype == torch.int32 and valid[got[3].numpy()].all()


def test_per_class_budgets_match_reference():
    feats, labels = _clusters(160, 5, 8, seed=4)
    y = (labels % 3).astype(np.int64)
    jsel = JS.StreamingSelector(12, 5, per_class=True)
    psel = S.StreamingSelector(12, 5, per_class=True, device="cpu")
    for lo in range(0, 160, 40):
        jsel.ingest(feats[lo:lo + 40], labels=y[lo:lo + 40])
        psel.ingest(feats[lo:lo + 40], labels=y[lo:lo + 40])
    got, want = psel.result(feats), jsel.result(feats)
    assert_same_result(feats, got, want, 12)
    assert float(got.weights.sum()) == 160.0
    counts = np.bincount(y[got.indices.numpy()], minlength=3)
    np.testing.assert_array_equal(counts, [5, 4, 3])  # 60, 60, 40 arrivals


@pytest.mark.parametrize("per_class", [False, True])
def test_eviction_matches_reference(per_class):
    feats, labels = _clusters(200, 4, 10, seed=5)
    y = (labels % 2).astype(np.int64) if per_class else None
    jsel = JS.StreamingSelector(8, 4, per_class=per_class, evict=True)
    psel = S.StreamingSelector(8, 4, per_class=per_class, evict=True, device="cpu")
    jpool = ppool = np.zeros((0, 4), np.float32)
    for lo in range(0, 200, 50):
        d = feats[lo:lo + 50]
        lab = None if y is None else y[lo:lo + 50]
        jsel.ingest(d, labels=lab)
        psel.ingest(d, labels=lab)
        jkeep, pkeep = jsel.compact(), psel.compact()
        np.testing.assert_array_equal(pkeep, jkeep)
        jpool = np.concatenate([jpool, d])[jkeep]
        ppool = np.concatenate([ppool, d])[pkeep]
    np.testing.assert_array_equal(psel.live_ids, jsel.live_ids)
    assert psel.n_rows == jsel.n_rows < 200 and psel.n_seen == 200
    got, want = psel.result(ppool), jsel.result(jpool)
    assert_same_result(ppool, got, want, 8)
    assert float(got.weights.sum()) == psel.n_rows


def _stream(selector, deltas, labels=None):
    for i, d in enumerate(deltas):
        selector.ingest(d, labels=None if labels is None else labels[i])


@pytest.mark.parametrize("per_class", [False, True])
def test_state_dict_resume_is_bit_identical(per_class):
    feats, lab = _clusters(160, 5, 8, seed=6)
    deltas = [feats[lo:lo + 32] for lo in range(0, 160, 32)]
    labels = [lab[lo:lo + 32] % 3 for lo in range(0, 160, 32)] if per_class else None
    a = S.StreamingSelector(10, 5, per_class=per_class, device="cpu")
    _stream(a, deltas, labels)
    b = S.StreamingSelector(10, 5, per_class=per_class, device="cpu")
    _stream(b, deltas[:2], None if labels is None else labels[:2])
    snap = json.loads(json.dumps(b.state_dict()))
    c = S.StreamingSelector(3, 2, device="cpu")  # shape comes from the snapshot
    c.load_state_dict(snap)
    assert c.state_dict() == snap
    _stream(c, deltas[2:], None if labels is None else labels[2:])
    assert c.state_dict() == a.state_dict()
    ra, rc = a.result(feats), c.result(feats)
    for f in ("indices", "gains", "weights", "coverage"):
        assert torch.equal(getattr(ra, f), getattr(rc, f)), f


def test_reference_state_dict_resumes_in_the_port():
    feats, _ = _clusters(160, 5, 8, seed=7)
    deltas = [feats[lo:lo + 32] for lo in range(0, 160, 32)]
    jsel = JS.StreamingSelector(10, 5, config=JE.StreamingConfig(finalize_impl="jax"))
    _stream(jsel, deltas[:3])
    snap = json.loads(json.dumps(jsel.state_dict()))
    psel = S.StreamingSelector(10, 5, device="cpu")
    psel.load_state_dict(snap)
    assert psel.config == E.StreamingConfig(finalize_impl="torch")
    assert psel.n_seen == 96
    _stream(jsel, deltas[3:])
    _stream(psel, deltas[3:])
    assert_same_result(feats, psel.result(feats), jsel.result(feats), 10)


def test_one_shot_engine_matches_reference():
    feats, labels = _clusters(96, 5, 8, seed=0, spread=0.25)
    got = E.make_engine(E.StreamingConfig(eps=0.05, levels=96)).select(torch.as_tensor(feats), 8)
    want = JE.make_engine(JE.StreamingConfig(eps=0.05, levels=96)).select(jnp.asarray(feats), 8)
    assert_same_result(feats, got, want, 8)
    assert sorted(labels[got.indices.numpy()]) == list(range(8))  # one per cluster
    got = E.make_engine(E.StreamingConfig()).select(torch.as_tensor(feats), 8,
                                                    init_selected=[5, 9], metric="cosine")
    want = JE.make_engine(JE.StreamingConfig()).select(jnp.asarray(feats), 8,
                                                       init_selected=[5, 9], metric="cosine")
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(float(got.coverage), float(want.coverage), rtol=1e-4)


@pytest.mark.parametrize("budget,eps,levels", [(10, 0.15, 32), (4, 0.15, 0), (100_000, 0.01, 0),
                                               (1024, 0.15, 0)])
def test_num_sieves_matches_reference(budget, eps, levels):
    assert S.num_sieves(budget, eps, levels) == JS.num_sieves(budget, eps, levels)
    assert S.num_sieves(1024, 0.15) == 56  # the coreset service's grid at budget 1024


def test_streaming_config_from_reference():
    d = JE.StreamingConfig(eps=0.1, finalize_impl="pallas", finalize_block_m=64).to_dict()
    assert engine_config_from_reference(d) == E.StreamingConfig(
        eps=0.1, finalize_impl="cuda", finalize_block_m=64)
    assert E.get_engine("streaming") is E.StreamingEngine
    with pytest.raises(ValueError, match="finalize impl"):
        S.streaming_result_blocked(S.init_streaming_state(2, 3, device="cpu"),
                                   torch.zeros(4, 3), 2, impl="pallas")


def test_fl_replay_kernel_refuses_cpu_tensors():
    x = torch.randn(9, 3)
    sq = (x * x).sum(1)
    valid = torch.ones(9, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fl_replay(x, x, valid, torch.zeros(9), 1.0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kfl.fl_replay_cuda(x, x, sq, sq, valid, torch.tensor(1.0), torch.zeros(9))
    assert ops.LAUNCHES["fl_replay"] == 0
