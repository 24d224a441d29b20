"""Port engines (matrix, features, device) against the JAX reference engines.

Both packages get the same numpy features.  The reference runs its engines
on the CPU with the jnp sweeps (``gains_impl='jax'``, which the reference's
own tests hold equal to its Pallas path); the port runs its plain-torch
twins.

Tie rule (``repro_torch.parity``): indices must agree up to the first
divergence, where both picks must be within τ = 8·√ε₃₂·max‖x‖ of the fp64
best gain (the self-distance rounding of the ‖x‖² + ‖y‖² − 2·x·y formula,
which differs between the two frameworks' dot orders).  Without a
divergence γ must be exactly equal, gains within rtol 1e-4 + atol τ, and
coverage within rtol 1e-4 + atol r·τ (each medoid's self-distance carries
up to τ).  Past a divergence the selections are compared by fp64 coverage
L(S), within 1e-3 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as JE
from repro_torch import parity
from repro_torch.core import engines as E
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

OBJECTIVE_RTOL = 1e-3


def _feats(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _cmp_x(x, metric):
    """The features the l2 greedy actually ran on for ``metric``."""
    t = torch.as_tensor(x)
    return E.normalize_for_metric(t, metric) if metric == "cosine" else t


def assert_same_selection(x, ref, got, *, metric="l2", exact_gains=True):
    """Hold a port FLResult to a reference FLResult under the tie rule."""
    xt = _cmp_x(x, metric)
    tau = parity.tie_tolerance(xt)
    ri, gi = np.asarray(ref.indices, np.int64), got.indices.numpy()
    t = parity.first_divergence(xt, ri, gi, tau)
    n = x.shape[0]
    assert float(got.weights.sum()) == pytest.approx(n)
    assert len(np.unique(gi)) == len(gi)
    if t is None:
        np.testing.assert_array_equal(got.weights.numpy(), np.asarray(ref.weights))
        if exact_gains:
            np.testing.assert_allclose(
                got.gains.numpy(), np.asarray(ref.gains), rtol=1e-4, atol=tau
            )
        np.testing.assert_allclose(
            float(got.coverage), float(ref.coverage), rtol=1e-4, atol=len(gi) * tau
        )
    else:
        ca, cb = parity.coverage64(xt, ri), parity.coverage64(xt, gi)
        assert abs(ca - cb) <= OBJECTIVE_RTOL * max(ca, cb), (t, ca, cb)
    return t


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("n,d,budget", [(7, 3, 3), (129, 22, 20), (600, 16, 40)])
def test_matrix_engine_matches_reference(n, d, budget, metric):
    x = _feats(n, d, seed=n + d)
    ref = JE.MatrixEngine().select(jnp.asarray(x), budget, metric=metric)
    got = E.MatrixEngine().select(torch.as_tensor(x), budget, metric=metric)
    assert_same_selection(x, ref, got, metric=metric)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("n,d,budget", [(1, 4, 1), (129, 22, 20), (1000, 22, 30)])
def test_features_engine_matches_reference(n, d, budget, metric):
    x = _feats(n, d, seed=2 * n + d)
    ref = JE.FeaturesEngine(JE.FeaturesConfig(gains_impl="jax", block_n=128)).select(
        jnp.asarray(x), budget, metric=metric
    )
    got = E.FeaturesEngine(E.FeaturesConfig(gains_impl="torch", block_n=128)).select(
        torch.as_tensor(x), budget, metric=metric
    )
    assert_same_selection(x, ref, got, metric=metric)


DEVICE_CASES = {
    "q1": dict(q=1),
    "q4-exact": dict(q=4, stale_tol=1.0),
    "q4-tol0.7": dict(q=4, stale_tol=0.7),
    "bf16": dict(q=1, tile_dtype="bfloat16"),
}


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
@pytest.mark.parametrize("n,d,budget", [(129, 22, 20), (1000, 22, 40)])
def test_device_engine_matches_reference(n, d, budget, case, metric):
    kw = DEVICE_CASES[case]
    x = _feats(n, d, seed=3 * n + d)
    ref = JE.DeviceEngine(JE.DeviceConfig(gains_impl="jax", block_m=256, **kw)).select(
        jnp.asarray(x), budget, metric=metric
    )
    got = E.DeviceEngine(E.DeviceConfig(gains_impl="torch", **kw)).select(
        torch.as_tensor(x), budget, metric=metric
    )
    assert_same_selection(x, ref, got, metric=metric)


@pytest.mark.parametrize("prefix", [1, 5])
def test_device_warm_start_matches_reference(prefix):
    x = _feats(500, 12, seed=8)
    cold = JE.DeviceEngine(JE.DeviceConfig(gains_impl="jax")).select(jnp.asarray(x), 25)
    init = np.asarray(cold.indices)[:prefix]
    ref = JE.DeviceEngine(JE.DeviceConfig(gains_impl="jax")).select(
        jnp.asarray(x), 25, init_selected=init
    )
    got = E.DeviceEngine(E.DeviceConfig(gains_impl="torch")).select(
        torch.as_tensor(x), 25, init_selected=init
    )
    assert_same_selection(x, ref, got)
    np.testing.assert_array_equal(got.indices.numpy()[:prefix], init)


def test_device_q1_equals_port_matrix_and_features():
    x = torch.as_tensor(_feats(300, 10, seed=21))
    a = E.DeviceEngine().select(x, 25)
    b = E.FeaturesEngine().select(x, 25)
    assert parity.first_divergence(x, a.indices, b.indices, parity.tie_tolerance(x)) is None
    np.testing.assert_array_equal(a.weights.numpy(), b.weights.numpy())


def test_device_stats_count_lazy_rounds():
    x = torch.as_tensor(_feats(400, 8, seed=2))
    stats: dict = {}
    E.greedy_fl_device(x, 60, q=8, stats=stats)
    assert stats["sweeps"] >= 60 // 8
    assert stats["lazy_rounds"] > 0
    assert stats["sweeps"] + stats["lazy_rounds"] >= 60
    stats1: dict = {}
    E.greedy_fl_device(x, 60, q=1, stats=stats1)
    assert stats1 == {"sweeps": 60, "lazy_rounds": 0}


@pytest.mark.parametrize(
    "n,backend,mode,expected",
    [
        (100, "cpu", "budget", "matrix"),
        (100, "cuda", "budget", "matrix"),
        (20_000, "cuda", "budget", "matrix"),
        (33_216, "cpu", "budget", "features"),
        (33_216, "cuda", "budget", "device"),
        (200_000, "cuda", "budget", "device"),
        (50_000, "cuda", "cover", "matrix"),
    ],
)
def test_auto_policy_table(n, backend, mode, expected):
    ec = E.auto_engine_config(n, backend=backend, mode=mode)
    assert ec.name == expected
    assert ec == E.get_engine(expected).config_cls()
    # the reference's TPU row is the port's CUDA row
    jb = {"cuda": "tpu", "cpu": "cpu"}[backend]
    assert JE.auto_engine_config(n, backend=jb, mode=mode).name == expected


def test_auto_policy_past_sparse_threshold_raises():
    # past 2·10⁵ points the sparse engine (ported with slice 3) takes over;
    # 'tree' names a provenance record, not an engine, as in the reference
    assert E.auto_engine_config(300_000, backend="cuda") == E.SparseConfig()
    with pytest.raises(ValueError, match="unknown engine 'tree'"):
        E.get_engine("tree")


def test_config_round_trip_and_spec():
    for cfg in (E.MatrixConfig(), E.FeaturesConfig(gains_impl="cuda"),
                E.DeviceConfig(q=16, stale_tol=0.8, tile_dtype="bfloat16"),
                E.LazyConfig(), E.StochasticConfig(delta=0.05)):
        assert E.EngineConfig.from_dict(cfg.to_dict()) == cfg
    assert E.parse_engine_spec("device:q=16,stale_tol=0.8") == E.DeviceConfig(
        q=16, stale_tol=0.8
    )
    assert E.list_engines() == ("matrix", "lazy", "stochastic", "features", "device",
                                "sparse", "streaming")
    assert E.registry.NOT_PORTED == {}
    from repro_torch.distributed.tree_select import TreeSelectConfig

    tree = TreeSelectConfig(fanouts=(4, 2), compress="none",
                            local=E.DeviceConfig(q=4).to_dict(), missing_pids=(3,))
    assert E.EngineConfig.from_dict(tree.to_dict()) == tree
