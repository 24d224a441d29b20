"""Port CraigSelector against the JAX reference selector on the CPU.

Same numpy features and labels into both packages; the port runs with
``device="cpu"``.  Index parity follows the tie rule of
``repro_torch.parity`` (τ = 8·√ε₃₂·max‖x‖, fp64 gains at the first
divergence), applied per class; γ must be exactly equal without a
divergence, and Σγ == n always.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import craig as jcraig
from repro.core import engines as JE
from repro_torch import parity
from repro_torch.core import engines as E
from repro_torch.core.craig import CraigConfig, CraigSelector, _apportion_budgets
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker


def _data(n, d, n_classes, seed):
    """Random features; labels a seeded permutation of equal-size classes
    (fixed class sizes let the reference reuse its compiled greedy)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.permutation(np.arange(n) % n_classes).astype(np.int32)
    return x, y


def _pair(x, labels=None, init=None, **cfg):
    """Run the reference and the port selector with the same settings."""
    jeng = cfg.pop("jengine", "auto")
    eng = cfg.pop("engine", "auto")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jcraig.CraigSelector(jcraig.CraigConfig(engine=jeng, **cfg)).select(
            jnp.asarray(x), labels, init_selected=init
        )
        got = CraigSelector(CraigConfig(engine=eng, **cfg), device="cpu").select(
            x, labels, init_selected=init
        )
    return ref, got


def assert_same_coreset(x, labels, ref, got):
    n = x.shape[0]
    assert got.weights.sum() == pytest.approx(n)
    assert len(np.unique(got.indices)) == got.size == ref.size
    groups = [np.arange(n)] if labels is None else [
        np.nonzero(labels == c)[0] for c in np.unique(labels)
    ]
    diverged = False
    for pool in groups:
        ri = [int(np.searchsorted(pool, i)) for i in ref.indices if i in set(pool)]
        gi = [int(np.searchsorted(pool, i)) for i in got.indices if i in set(pool)]
        xt = torch.as_tensor(x[pool])
        t = parity.first_divergence(xt, ri, gi, parity.tie_tolerance(xt))
        diverged |= t is not None
    if not diverged:
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_array_equal(got.weights, ref.weights)
        assert got.coverage == pytest.approx(ref.coverage, rel=1e-4, abs=1e-2)
    assert got.per_class_sizes == ref.per_class_sizes


@pytest.mark.parametrize("per_class", [False, True])
def test_budget_mode_matches_reference(per_class):
    x, y = _data(300, 8, 2, seed=1)
    ref, got = _pair(x, y if per_class else None, fraction=0.1, per_class=per_class)
    assert got.engine == ref.engine == {"name": "matrix"}
    assert_same_coreset(x, y if per_class else None, ref, got)


@pytest.mark.parametrize("engine", ["features", "device"])
def test_per_class_typed_engines_match_reference(engine):
    x, y = _data(300, 8, 2, seed=2)
    jcfg = {"features": JE.FeaturesConfig(), "device": JE.DeviceConfig(gains_impl="jax")}[engine]
    cfg = {"features": E.FeaturesConfig(), "device": E.DeviceConfig()}[engine]
    ref, got = _pair(x, y, fraction=0.05, jengine=jcfg, engine=cfg)
    assert got.engine["name"] == engine
    assert_same_coreset(x, y, ref, got)


def test_cover_mode_matches_reference():
    x, _ = _data(90, 5, 2, seed=3)
    ref, got = _pair(x, None, mode="cover", epsilon=60.0, per_class=False)
    assert_same_coreset(x, None, ref, got)


def test_warm_start_matches_reference():
    x, y = _data(300, 8, 2, seed=4)
    cold, _ = _pair(x, y, fraction=0.1)
    init = cold.indices[::3]
    ref, got = _pair(x, y, init=init, fraction=0.1)
    assert_same_coreset(x, y, ref, got)


def test_cosine_metric_matches_reference():
    x, y = _data(300, 8, 2, seed=5)
    ref, got = _pair(x, y, fraction=0.1, metric="cosine")
    assert_same_coreset(x, y, ref, got)


def test_validate_features_raise_and_drop():
    x, y = _data(302, 8, 2, seed=6)
    x[[3, 50]] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        CraigSelector(CraigConfig(), device="cpu").select(x, y)
    ref, got = _pair(x, y, fraction=0.1, validate_features="drop")
    assert got.n_dropped == ref.n_dropped == 2
    assert not np.isin([3, 50], got.indices).any()
    keep = np.setdiff1d(np.arange(302), [3, 50])
    np.testing.assert_array_equal(got.indices, ref.indices)
    assert got.weights.sum() == pytest.approx(len(keep))


def test_apportion_budgets_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(50):
        counts = rng.integers(1, 40, size=rng.integers(1, 12))
        total = int(rng.integers(1, counts.sum() + 5))
        np.testing.assert_array_equal(
            _apportion_budgets(counts, total), jcraig._apportion_budgets(counts, total)
        )


def test_weights_sum_to_n_when_budget_cannot_cover_classes():
    labels = np.concatenate([np.zeros(50, np.int64), np.arange(1, 31)])
    x = np.random.default_rng(1).normal(size=(80, 8)).astype(np.float32)
    ref, got = _pair(x, labels, fraction=0.1)
    assert got.size == 8 and got.weights.sum() == pytest.approx(80.0)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.weights, ref.weights)


# Legacy engine strings with flat knobs.  The port's impl knobs default to
# 'auto' (the reference's to 'jax', which here would be the plain twin on a
# card), so the reference is given 'auto' where the port keeps its default.
_PORT_IMPL_DEFAULTS = {"gains_impl": "auto", "topk_impl": "auto"}
_LEGACY_KNOBS = [
    {},
    {"gains_impl": "pallas", "topk_impl": "pallas", "topk_k": 32, "device_q": 16,
     "device_stale_tol": 0.8, "device_tile_dtype": "bfloat16", "stochastic_delta": 0.05},
    {"gains_impl": "jax", "topk_impl": "jax", "topk_k": 7, "device_q": 4},
]


@pytest.mark.parametrize("knobs", range(len(_LEGACY_KNOBS)))
@pytest.mark.parametrize("legacy", ["matrix", "lazy", "stochastic", "features", "sparse",
                                    "device"])
def test_legacy_engine_strings_warn_and_map_as_the_reference(legacy, knobs):
    from repro.core.engines.legacy import resolve_engine_config as jresolve
    from repro_torch import convert
    from repro_torch.core.engines.legacy import resolve_engine_config

    kw = _LEGACY_KNOBS[knobs]
    with pytest.warns(DeprecationWarning, match=f"engine='{legacy}'"):
        want = jresolve(jcraig.CraigConfig(engine=legacy, **{**_PORT_IMPL_DEFAULTS, **kw}))
    with pytest.warns(DeprecationWarning, match=f"engine='{legacy}'") as rec:
        got = resolve_engine_config(CraigConfig(engine=legacy, **kw))
    assert got == convert.engine_config_from_reference(want.to_dict())
    assert len(rec) == 1
    # the port's own implementation names map to themselves
    port_kw = {k: {"jax": "torch", "pallas": "cuda"}.get(v, v) for k, v in kw.items()}
    with pytest.warns(DeprecationWarning):
        assert resolve_engine_config(CraigConfig(engine=legacy, **port_kw)) == got


@pytest.mark.parametrize("legacy", ["matrix", "lazy", "stochastic", "features", "sparse",
                                    "device"])
def test_legacy_engine_string_selects(legacy):
    x, y = _data(90, 4, 3, seed=4)
    with pytest.warns(DeprecationWarning) as rec:
        cs = CraigSelector(CraigConfig(engine=legacy, fraction=0.2), device="cpu").select(x, y)
    assert len(rec) == 1 and rec[0].filename == __file__  # the caller's line
    assert cs.engine["name"] == legacy and cs.size == 18
    assert cs.weights.sum() == pytest.approx(90.0)


def test_legacy_knobs_beside_a_typed_engine_warn_and_bad_strings_raise():
    from repro_torch.core.engines.legacy import resolve_engine_config

    with pytest.warns(UserWarning, match="ignores the legacy flat engine knobs"):
        assert resolve_engine_config(CraigConfig(engine=E.MatrixConfig(), topk_k=3)) == \
            E.MatrixConfig()
    with pytest.warns(UserWarning, match="ignores"):
        assert resolve_engine_config(CraigConfig(device_q=2)) is None  # 'auto'
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_engine_config(CraigConfig()) is None
    with pytest.raises(ValueError, match="unknown engine 'tree'"):
        resolve_engine_config(CraigConfig(engine="tree"))
    with pytest.raises(ValueError, match="unknown implementation name"):
        resolve_engine_config(CraigConfig(engine="features", gains_impl="mosaic"))
    with pytest.raises(TypeError):
        CraigConfig("budget")  # the inherited knobs keep the config keyword-only
