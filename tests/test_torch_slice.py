"""Slice 1 end to end: the port against the JAX package on the CPU.

The quickstart flow (paper Fig. 1 miniature at 1,500 × 20, seed 0), a
per-class device-engine selection on a ~3,000-point pool, the weighted
IG/SAGA/SVRG iterates, and the ``repro_torch.convert`` round trips.

Tolerances: selections follow the tie rule of ``repro_torch.parity``
(τ = 8·√ε₃₂·max‖x‖ on fp64 gains at the first divergence; γ exactly equal
without one).  Iterates: rtol 1e-4, atol 1e-7 — both sides take the same
fp32 steps, but XLA and PyTorch round the d-term dot products and the
per-step updates in different orders, and that drift compounds over an
epoch's few hundred steps.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import craig as jcraig
from repro.core import proxy as jproxy
from repro.core import engines as JE
from repro.data.synthetic import make_classification as jmake
from repro.distributed import tree_select as JT
from repro.optim import variance_reduced as jvr
from repro_torch import convert, parity
from repro_torch.core import engines as E
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.core.proxy import classifier_last_layer_proxy, convex_feature_proxy
from repro_torch.data.synthetic import make_classification
from repro_torch.distributed import tree_select as T
from repro_torch.examples.quickstart import logistic, schedule_for
from repro_torch.optim import ig_run, saga_run, svrg_run
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

REPO = Path(__file__).resolve().parent.parent
LAM = 1e-5


def _quickstart_data(n=1500, d=20):
    x, y = make_classification(n, d, 2, seed=0)
    return x / np.abs(x).max(), y


def _divergences(x, labels, ref_idx, got_idx):
    """Per-class first divergence under the tie rule (None = identical)."""
    out = {}
    for c in np.unique(labels):
        pool = np.nonzero(labels == c)[0]
        members = set(pool.tolist())
        ri = [int(np.searchsorted(pool, i)) for i in ref_idx if int(i) in members]
        gi = [int(np.searchsorted(pool, i)) for i in got_idx if int(i) in members]
        xt = torch.as_tensor(x[pool])
        out[int(c)] = parity.first_divergence(xt, ri, gi, parity.tie_tolerance(xt))
    return out


def _class_coverage64(x, labels, idx):
    total = 0.0
    for c in np.unique(labels):
        pool = np.nonzero(labels == c)[0]
        own = np.searchsorted(pool, idx[np.isin(idx, pool)])
        total += parity.coverage64(torch.as_tensor(x[pool]), own)
    return total


def _assert_same_coreset(x, labels, ref, got):
    """Identical indices and γ, unless the runs part at a near-tie (checked
    by the tie rule); then fp64 coverage within 1e-3 relative."""
    assert got.size == ref.size
    assert got.per_class_sizes == ref.per_class_sizes
    assert got.weights.sum() == pytest.approx(ref.weights.sum())
    div = _divergences(x, labels, ref.indices, got.indices)
    if all(t is None for t in div.values()):
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_array_equal(got.weights, ref.weights)
        return
    ca = _class_coverage64(x, labels, ref.indices)
    cb = _class_coverage64(x, labels, got.indices)
    assert abs(ca - cb) <= 1e-3 * ca, (div, ca, cb)


def test_synthetic_data_is_identical():
    for args in ((1500, 20, 2, 0), (49_990, 22, 2, 0)):
        xa, ya = make_classification(*args)
        xb, yb = jmake(*args)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    _, y = make_classification(49_990, 22, 2, seed=0)
    assert np.bincount(y).tolist() == [33_216, 16_774]


def test_proxies_match_reference():
    """Eq. 9 and Eq. 16 proxies: elementwise fp32 math, rtol 1e-6."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(50, 7)).astype(np.float32)
    for normalize in (False, True):
        np.testing.assert_allclose(
            convex_feature_proxy(x, normalize, device="cpu").numpy(),
            np.asarray(jproxy.convex_feature_proxy(jnp.asarray(x), normalize)),
            rtol=1e-6, atol=1e-7,
        )
    logits = rng.normal(size=(50, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=50).astype(np.int32)
    np.testing.assert_allclose(
        classifier_last_layer_proxy(torch.as_tensor(logits), torch.as_tensor(labels)).numpy(),
        np.asarray(jproxy.classifier_last_layer_proxy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-7,
    )


def test_quickstart_selects_the_reference_coreset():
    """Same flow as both quickstarts: per-class CRAIG at fraction 0.1."""
    x, y = _quickstart_data()
    ref = jcraig.CraigSelector(jcraig.CraigConfig(fraction=0.1, per_class=True)).select(
        jnp.asarray(x), y
    )
    got = CraigSelector(CraigConfig(fraction=0.1, per_class=True), device="cpu").select(
        convex_feature_proxy(x, device="cpu"), y
    )
    assert got.engine == ref.engine == {"name": "matrix"}
    assert got.size == 150 and got.weights.sum() == 1500
    _assert_same_coreset(x, y, ref, got)


def test_per_class_device_engine_selects_the_reference_coreset():
    x, y = make_classification(3000, 22, 2, seed=0)
    ref = jcraig.CraigSelector(
        jcraig.CraigConfig(fraction=0.1, engine=JE.DeviceConfig())
    ).select(jnp.asarray(x), y)
    got = CraigSelector(
        CraigConfig(fraction=0.1, engine=E.DeviceConfig()), device="cpu"
    ).select(x, y)
    assert got.engine == E.DeviceConfig().to_dict()
    assert got.coverage == pytest.approx(ref.coverage, rel=1e-3)
    _assert_same_coreset(x, y, ref, got)


def _jax_logistic(x, y01):
    X, ybin = jnp.asarray(x), jnp.asarray(y01 * 2.0 - 1.0, jnp.float32)

    def grad_one(w, i):
        s = jax.nn.sigmoid(-ybin[i] * (X[i] @ w))
        return -s * ybin[i] * X[i] + LAM * w

    def full_loss(w):
        z = -ybin * (X @ w)
        return float(jnp.mean(jnp.log1p(jnp.exp(z))) + 0.5 * LAM * w @ w)

    return grad_one, full_loss


@pytest.mark.parametrize(
    "port_run,ref_run",
    [(ig_run, jvr.ig_run), (saga_run, jvr.saga_run), (svrg_run, jvr.svrg_run)],
    ids=["ig", "saga", "svrg"],
)
def test_weighted_iterates_match_reference(port_run, ref_run):
    x, y = _quickstart_data(n=300, d=10)
    rng = np.random.default_rng(7)
    order = rng.choice(300, 40, replace=False)
    gamma = rng.integers(1, 15, size=40).astype(np.float32)
    sched = schedule_for(300)
    jgrad, _ = _jax_logistic(x, y)
    tgrad, _ = logistic(torch.as_tensor(x), y, LAM)
    _, jtrace = ref_run(jgrad, jnp.zeros(10), jnp.asarray(order, jnp.int32),
                        jnp.asarray(gamma), sched, 3)
    _, ttrace = port_run(tgrad, torch.zeros(10), order, gamma, sched, 3)
    for a, b in zip(jtrace, ttrace):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-7)


def test_reference_selection_warm_starts_the_port():
    x, y = make_classification(600, 12, 2, seed=3)
    jsel = jcraig.CraigSelector(jcraig.CraigConfig(fraction=0.1)).select(jnp.asarray(x), y)
    conv = convert.selection_from_reference(
        jsel.indices, jsel.weights, coverage=jsel.coverage,
        per_class_sizes=jsel.per_class_sizes, engine=jsel.engine,
    )
    np.testing.assert_array_equal(conv.indices, jsel.indices)
    assert conv.engine == {"name": "matrix"}
    init = conv.indices[::2]  # every other medoid of each class, greedy order
    ref = jcraig.CraigSelector(jcraig.CraigConfig(fraction=0.1)).select(
        jnp.asarray(x), y, init_selected=init
    )
    got = CraigSelector(CraigConfig(fraction=0.1), device="cpu").select(
        x, y, init_selected=init
    )
    assert np.isin(init, got.indices).all()
    _assert_same_coreset(x, y, ref, got)


def test_engine_configs_carry_across():
    cases = [
        (JE.DeviceConfig(q=4, gains_impl="pallas", tile_dtype="bfloat16"),
         E.DeviceConfig(q=4, gains_impl="cuda", tile_dtype="bfloat16")),
        (JE.DeviceConfig(), E.DeviceConfig()),
        (JE.FeaturesConfig(gains_impl="jax", block_n=256),
         E.FeaturesConfig(gains_impl="torch", block_n=256)),
        (JE.MatrixConfig(), E.MatrixConfig()),
        (JE.SparseConfig(k=16, impl="pallas"), E.SparseConfig(k=16, impl="cuda")),
        (JE.StreamingConfig(finalize_impl="jax"), E.StreamingConfig(finalize_impl="torch")),
        (JE.LazyConfig(), E.LazyConfig()),
        (JE.StochasticConfig(delta=0.05), E.StochasticConfig(delta=0.05)),
        # a tree provenance, its leaf engine nested (ported with slice 9)
        (JT.TreeSelectConfig(fanouts=(4, 2), local=JE.DeviceConfig(gains_impl="jax").to_dict(),
                             degraded=True, missing_pids=(3,), quorum=0.875),
         T.TreeSelectConfig(fanouts=(4, 2), local=E.DeviceConfig(gains_impl="torch").to_dict(),
                            degraded=True, missing_pids=(3,), quorum=0.875)),
    ]
    for ref_cfg, want in cases:
        assert convert.engine_config_from_reference(ref_cfg.to_dict()) == want
    # an engine neither package has raises
    with pytest.raises(ValueError, match="unknown engine"):
        convert.engine_config_from_reference({"name": "bogus"})


def test_reference_weights_give_the_same_port_loss():
    x, y = _quickstart_data(n=400, d=12)
    jgrad, jloss = _jax_logistic(x, y)
    w_ref, _ = jvr.ig_run(jgrad, jnp.zeros(12), jnp.arange(400, dtype=jnp.int32),
                          jnp.ones(400), schedule_for(400), 2)
    w = convert.params_from_reference(np.asarray(w_ref), device="cpu")
    _, tloss = logistic(torch.as_tensor(x), y, LAM)
    assert w.dtype == torch.float32 and w.shape == (12,)
    assert tloss(w) == pytest.approx(jloss(w_ref), rel=1e-6)
    assert tloss(w) < np.log(2.0)


def test_quickstart_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu", "--epochs", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "selected 150/1500 examples" in proc.stdout
    assert "engine matrix" in proc.stdout
    for arm in ("full", "craig", "random"):
        assert arm in proc.stdout
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert "Traceback" not in proc.stderr
