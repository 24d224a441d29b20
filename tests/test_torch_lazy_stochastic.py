"""The port's lazy and stochastic engines against the JAX reference, and
every engine at full k through the port's façade, on the CPU.

Tolerances.  ``lazy_greedy_fl`` on one float64 matrix: the reference's
numpy arithmetic, so indices, gains, γ and coverage are equal.  The
engines, which compute their fp32 distances each in its own framework,
follow the tie rule of ``repro_torch.parity`` (τ = 8·√ε₃₂·max‖x‖; past a
divergence fp64 L(S) within 1e-3 relative), with γ equal and gains within
rtol 1e-4 + atol τ where the indices agree.  ``stochastic_greedy_fl`` on
one fp32 matrix with the reference's candidates injected: indices and γ
equal, gains within rtol 1e-5 (each a sum of the same fp32 terms in
another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as JE
from repro.core.engines import lazy as JL
from repro.core.engines import stochastic as JS
from repro_torch import parity
from repro_torch.core import engines as E
from repro_torch.core import facility_location as fl
from repro_torch.core.engines import stochastic as S
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

OBJECTIVE_RTOL = 1e-3


def _feats(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _sim(x):
    """The reference's fp32 similarity matrix d_max − dist, as numpy."""
    dist = JE.pairwise_distances(jnp.asarray(x))
    return np.array(jnp.max(dist) + 1e-6 - dist)


def assert_tie_rule(x, want_idx, got, want_weights=None, want_gains=None):
    """Hold ``got`` (an FLResult) to ``want_idx`` under the tie rule."""
    xt = torch.as_tensor(x)
    tau = parity.tie_tolerance(xt)
    want_idx = np.asarray(want_idx, np.int64)
    got_idx = got.indices.cpu().numpy()
    assert len(np.unique(got_idx)) == len(got_idx)
    assert float(got.weights.sum()) == pytest.approx(x.shape[0])
    t = parity.first_divergence(xt, want_idx, got_idx, tau)
    if t is None:
        if want_weights is not None:
            np.testing.assert_array_equal(got.weights.cpu().numpy(), np.asarray(want_weights))
        if want_gains is not None:
            np.testing.assert_allclose(got.gains.cpu().numpy(), np.asarray(want_gains),
                                       rtol=1e-4, atol=tau)
    else:
        ca, cb = parity.coverage64(xt, want_idx), parity.coverage64(xt, got_idx)
        assert abs(ca - cb) <= OBJECTIVE_RTOL * max(ca, cb), (t, ca, cb)
    return t


# -- lazy ----------------------------------------------------------------------


@pytest.mark.parametrize("n,d,budget,r0", [(1, 3, 1, 0), (40, 4, 9, 0), (150, 8, 30, 0),
                                           (150, 8, 30, 7), (300, 16, 300, 0)])
def test_lazy_greedy_fl_is_the_reference_on_one_matrix(n, d, budget, r0):
    sim = _sim(_feats(n, d, seed=n + d))
    init = None
    if r0:
        init = np.asarray(JL.lazy_greedy_fl(sim, r0).indices, np.int64)
    want = JL.lazy_greedy_fl(sim, budget, init_selected=init)
    for arg in (sim, torch.as_tensor(sim)):  # a tensor crosses column-major
        got = E.lazy_greedy_fl(arg, budget, init_selected=init)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.gains.numpy(), np.asarray(want.gains))
        np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
        assert float(got.coverage) == float(want.coverage)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("n,d,budget", [(7, 3, 3), (129, 22, 20), (300, 16, 40)])
def test_lazy_engine_matches_reference_and_matrix(n, d, budget, metric):
    x = _feats(n, d, seed=3 * n + d)
    ref = JE.LazyEngine().select(jnp.asarray(x), budget, metric=metric)
    got = E.LazyEngine().select(torch.as_tensor(x), budget, metric=metric)
    mat = E.MatrixEngine().select(torch.as_tensor(x), budget, metric=metric)
    xm = np.asarray(E.normalize_for_metric(torch.as_tensor(x), metric))
    if assert_tie_rule(xm, np.asarray(ref.indices), got, ref.weights, ref.gains) is None:
        assert float(got.coverage) == pytest.approx(float(ref.coverage), rel=1e-4, abs=1e-3)
    assert_tie_rule(xm, mat.indices.numpy(), got, mat.weights, mat.gains)


def test_lazy_warm_start_equals_cold_and_reference():
    x = _feats(200, 8, seed=5)
    cold = E.LazyEngine().select(torch.as_tensor(x), 25)
    init = cold.indices[:10].numpy()
    warm = E.LazyEngine().select(torch.as_tensor(x), 25, init_selected=init)
    torch.testing.assert_close(warm.indices, cold.indices, rtol=0, atol=0)
    torch.testing.assert_close(warm.weights, cold.weights, rtol=0, atol=0)
    ref = JE.LazyEngine().select(jnp.asarray(x), 25, init_selected=init)
    assert_tie_rule(x, np.asarray(ref.indices), warm, ref.weights, ref.gains)


def test_lazy_init_longer_than_budget_raises():
    sim = _sim(_feats(20, 3, seed=0))
    with pytest.raises(ValueError, match="> budget"):
        E.lazy_greedy_fl(sim, 3, init_selected=np.arange(4))
    with pytest.raises(ValueError, match="> budget"):
        E.LazyEngine().select(torch.as_tensor(_feats(20, 3, seed=0)), 2,
                              init_selected=np.arange(3))


# -- stochastic ----------------------------------------------------------------


def _reference_draws(monkeypatch, seed, record=None):
    """Make the port draw the reference's candidates: ``jax.random.split``
    of ``PRNGKey(seed)`` into one key a step, ``randint`` of m on each."""

    def draw(key, steps, n, m):
        keys = jax.random.split(jax.random.PRNGKey(seed), steps)
        out = torch.as_tensor(np.stack(
            [np.asarray(jax.random.randint(k, (m,), 0, n)) for k in keys]
        ).astype(np.int64).reshape(steps, m))
        if record is not None:
            record.append(out)
        return out

    monkeypatch.setattr(S, "draw_candidates", draw)


@pytest.mark.parametrize("n,d,budget,m,r0", [(50, 4, 10, 12, 0), (200, 8, 25, 37, 0),
                                             (200, 8, 25, 37, 6), (300, 16, 60, 24, 0)])
def test_stochastic_is_the_reference_on_injected_candidates(monkeypatch, n, d, budget, m, r0):
    sim = _sim(_feats(n, d, seed=n + m))
    init = np.arange(0, 3 * r0, 3) if r0 else None
    want = JS.stochastic_greedy_fl(jnp.asarray(sim), budget, jax.random.PRNGKey(4), m,
                                   init_selected=None if init is None else jnp.asarray(init))
    _reference_draws(monkeypatch, 4)
    got = E.stochastic_greedy_fl(torch.as_tensor(sim), budget, 123, m, init_selected=init)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_allclose(got.gains.numpy(), np.asarray(want.gains), rtol=1e-5)
    np.testing.assert_allclose(float(got.coverage), float(want.coverage), rtol=1e-5)


def test_stochastic_engine_is_the_reference_on_injected_candidates(monkeypatch):
    """Through the engine: the same sample size, and L(S) from the
    distances.  The two frameworks' fp32 distances differ by rounding, which
    could part the picks only at a near-tie among a step's candidates; this
    pool has none, so the selections are equal."""
    x = _feats(240, 6, seed=11)
    cfg = E.StochasticConfig(delta=0.05)
    m = math.ceil(240 / 24 * math.log(1 / 0.05))
    assert S.sample_size(240, 24, 0.05) == m == 30
    record = []
    _reference_draws(monkeypatch, 7, record)
    ref = JE.StochasticEngine(JE.StochasticConfig(delta=0.05)).select(jnp.asarray(x), 24, rng=7)
    got = E.StochasticEngine(cfg).select(torch.as_tensor(x), 24, rng=7)
    assert record[0].shape == (24, 30)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(ref.weights))
    assert float(got.coverage) == pytest.approx(float(ref.coverage), rel=1e-5)


def test_stochastic_fallback_when_every_candidate_is_chosen(monkeypatch):
    sim = _sim(_feats(6, 3, seed=2))
    # the reference's own draws at n = r = 6, m = 1: collisions force the
    # first-unchosen fallback
    want = JS.stochastic_greedy_fl(jnp.asarray(sim), 6, jax.random.PRNGKey(0), 1)
    _reference_draws(monkeypatch, 0)
    got = E.stochastic_greedy_fl(torch.as_tensor(sim), 6, 0, 1)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.gains.numpy(), np.asarray(want.gains), rtol=1e-5)
    assert sorted(got.indices.tolist()) == list(range(6))
    # every step samples candidate 0: steps 2–6 all fall back, in order
    monkeypatch.setattr(S, "draw_candidates",
                        lambda key, steps, n, m: torch.zeros((steps, m), dtype=torch.int64))
    got = E.stochastic_greedy_fl(torch.as_tensor(sim), 6, 0, 2)
    assert got.indices.tolist() == [0, 1, 2, 3, 4, 5]
    assert float(got.weights.sum()) == 6.0


@pytest.mark.parametrize("n,budget", [(9, 4), (120, 15)])
def test_stochastic_full_sweep_is_exact_greedy(n, budget):
    x = _feats(n, 5, seed=n)
    sim = torch.as_tensor(_sim(x))
    got = E.stochastic_greedy_fl(sim, budget, 0, n)  # m ≥ n: every candidate
    mat = E.greedy_fl_matrix(sim, budget)
    assert_tie_rule(x, mat.indices.numpy(), got, mat.weights, mat.gains)
    # the engine reaches the full sweep when the sample covers the pool
    eng = E.StochasticEngine(E.StochasticConfig(delta=1e-30)).select(torch.as_tensor(x), budget)
    assert_tie_rule(x, E.MatrixEngine().select(torch.as_tensor(x), budget).indices.numpy(), eng)


def test_stochastic_candidates_come_from_one_cpu_stream():
    """The candidates are the CPU generator's whatever the device, so a
    run on the card samples what a run on the CPU does (chip_smoke.py
    phase 10 holds the two)."""
    c = S.draw_candidates(5, 4, 100, 7)
    assert c.device.type == "cpu" and c.dtype == torch.int64 and c.shape == (4, 7)
    torch.testing.assert_close(
        c, torch.randint(0, 100, (4, 7), generator=torch.Generator().manual_seed(5)))
    torch.testing.assert_close(S.draw_candidates(torch.Generator().manual_seed(5), 4, 100, 7), c)
    torch.testing.assert_close(S.draw_candidates(None, 4, 100, 7), S.draw_candidates(0, 4, 100, 7))
    x = torch.as_tensor(_feats(150, 4, seed=1))
    a = E.StochasticEngine().select(x, 12, rng=3)
    b = E.StochasticEngine().select(x, 12, rng=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.indices, b.indices, rtol=0, atol=0)


# -- every engine at full k ----------------------------------------------------


@pytest.mark.parametrize("n,seed,r", [(6, 21, 3), (6, 0, 6), (9, 7, 4), (9, 100, 2),
                                      (13, 3, 5), (13, 58, 1), (13, 99, 13)])
def test_all_engines_equivalent_at_full_k(n, seed, r):
    """With the graph at k = n and the stochastic sample at its δ→0 limit,
    every engine is exact greedy: unique indices, non-increasing gains,
    Σγ == n, and the matrix engine's selection under the tie rule (on an
    exact fp32 tie the engines may part; then the objectives are held)."""
    x = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    feats = torch.as_tensor(x)
    dist = E.pairwise_distances(feats)
    sim = torch.max(dist) + 1e-6 - dist
    base = fl.greedy_fl_matrix(sim, r)
    vals, idx = fl.topk_graph(feats, n)
    results = {
        "lazy": fl.lazy_greedy_fl(sim, r),
        "stochastic": fl.stochastic_greedy_fl(sim, r, 0, n),
        "features": fl.greedy_fl_features(feats, r),
        "topk": fl.greedy_fl_topk(vals, idx, r),
        "sparse": fl.sparse_greedy_fl(vals, idx, r, feats=feats),
        "device": fl.greedy_fl_device(feats, r, q=1),
    }
    mask = torch.zeros(n, dtype=torch.bool)
    mask[base.indices] = True
    f_base = float(fl.facility_location_value(sim, mask))
    for name, res in results.items():
        g = res.gains.cpu().numpy()
        assert np.all(g[:-1] >= g[1:] - 1e-3), (name, g)
        assert float(res.weights.sum()) == pytest.approx(float(n), rel=1e-5), name
        assert_tie_rule(x, base.indices.numpy(), res)
        mask = torch.zeros(n, dtype=torch.bool)
        mask[res.indices.cpu()] = True
        assert float(fl.facility_location_value(sim, mask)) == pytest.approx(f_base, rel=1e-3)


def test_facility_location_value_matches_reference():
    x = _feats(30, 4, seed=9)
    sim = _sim(x)
    for sel in ([], [3], [0, 7, 29]):
        mask = np.zeros(30, bool)
        mask[sel] = True
        want = float(JE.base.facility_location_value(jnp.asarray(sim), jnp.asarray(mask)))
        got = float(fl.facility_location_value(torch.as_tensor(sim), torch.as_tensor(mask)))
        assert got == pytest.approx(want, rel=1e-6)
    assert set(fl.__all__) == set(__import__("repro.core.facility_location",
                                             fromlist=["__all__"]).__all__)


def test_tie_rule_takes_the_best_of_a_stochastic_step_sample():
    """``parity.first_divergence(..., candidates=...)``: a stochastic pick
    is held to the best of its own step's sample, not of the pool."""
    x = _feats(40, 3, seed=6)
    c = int(torch.argsort(parity.fp64_gains(torch.as_tensor(x), []))[20])  # a middling point
    twin = (c + 1) % 40
    x[twin] = x[c]  # an exact tie
    xt = torch.as_tensor(x)
    tau = parity.tie_tolerance(xt)
    g = parity.fp64_gains(xt, [])
    worst = int(torch.argmin(g))
    sample = [[c, twin, worst]]
    assert float(g[c]) - float(g[worst]) > tau and float(g.max()) - float(g[c]) > tau
    assert parity.first_divergence(xt, [c], [twin], tau, candidates=sample) == 0
    with pytest.raises(AssertionError, match="not a near-tie"):
        parity.first_divergence(xt, [c], [twin], tau)  # c is not the pool's best
    with pytest.raises(AssertionError, match="not a near-tie"):
        parity.first_divergence(xt, [c], [worst], tau, candidates=sample)
