"""The port's seven registered LM configurations against the JAX reference
on the CPU: the published configs, their smoke variants, and the smoke
models' forward, loss, MoE auxiliary loss, gradients and proxies.

Weights come from ``repro.models.init_params`` and are carried across by
``repro_torch.convert.model_params_from_reference``; the same numpy batch
goes into both packages.  qwen2-7b's QKV bias trips the reference's
implicit rank promotion under conftest's 'raise' (ROADMAP.md queue 3), so
reference calls run under ``jax.numpy_rank_promotion("allow")``.

Tolerances, as ``test_torch_lm_model.py`` states them: fp32 (both
packages' ``COMPUTE_DTYPE`` set to float32) rtol 1e-5, atol 1e-5 for
hidden states and losses, rtol 1e-4, atol 1e-6 for gradients, rtol 1e-4,
atol 1e-5 for proxies (after the whole model); bf16 |Δ| ≤ 2⁻⁵·max|ref|
for hidden states and rtol 1e-2 for losses.  The MoE auxiliary loss is a
mean of fp32 router probabilities: rtol 1e-5 in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.configs import registry as jregistry
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models.config import validate_config
from torch_lm_checks import ref_init, strict_jit
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

ARCH_NAMES = ["qwen3-1.7b", "qwen2-7b", "granite-3-8b", "nemotron-4-15b",
              "moonshot-v1-16b-a3b", "dbrx-132b", "recurrentgemma-9b"]
B, T = 3, 16


@pytest.fixture(params=["fp32", "bf16"])
def dtype_mode(request, monkeypatch):
    if request.param == "fp32":
        monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    return request.param


@pytest.fixture
def fp32_models(monkeypatch):
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)


def _np(t):
    return t.detach().float().numpy()


def _setup(arch, seed=0):
    jcfg, cfg = jregistry.smoke_config(arch), smoke_config(arch)
    jp = ref_init(jcfg, seed)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "weights": rng.uniform(0.2, 3.0, B).astype(np.float32)}
    return jcfg, cfg, jp, tp, batch


def _ref(fn, params, jcfg, *args):
    """``fn(params, jcfg, *args)`` of the reference, jitted (traced afresh
    per call, so the monkeypatched ``COMPUTE_DTYPE`` is the one read) and
    compiled without excess precision (``torch_lm_checks.strict_jit``):
    each bf16 op rounds, as the reference's ops do one by one and the
    port's do (by default XLA keeps fp32 inside a fusion, enough to flip
    a bf16 MoE routing near-tie)."""
    with jax.numpy_rank_promotion("allow"):  # the reference's QKV-bias add
        return strict_jit(lambda p, *a: fn(p, jcfg, *a))(params, *args)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_the_registry_holds_six_archs():
    """The registry holds the reference's ten architectures; this file
    holds the token-frontend LMs of ARCH_NAMES (the xLSTM, vision and audio
    ones: tests/test_torch_xlstm.py, tests/test_torch_frontends.py)."""
    assert sorted(ARCHS) == sorted(jregistry.ARCHS)
    assert set(ARCH_NAMES) < set(ARCHS)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_is_the_reference(arch):
    for ours, theirs in ((get_config(arch), jregistry.get_config(arch)),
                         (smoke_config(arch), jregistry.smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
        validate_config(ours)
    assert set(tmodel.param_shapes(smoke_config(arch))) == set(
        tmodel.init_params(smoke_config(arch), torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_forward_and_loss_match_reference(arch, dtype_mode):
    jcfg, cfg, jp, tp, batch = _setup(arch)
    want, (total, m) = _ref(lambda p, c, b: (jmodel.forward(p, c, b)[0],
                                             jmodel.loss_fn(p, c, b)), jp, jcfg, _jb(batch))
    got, aux = tmodel.forward(tp, cfg, _tb(batch))
    ttotal, tm = tmodel.loss_fn(tp, cfg, _tb(batch))
    assert got.dtype == tmodel.COMPUTE_DTYPE and got.shape == (B, T, cfg.d_model)
    want = np.asarray(want.astype(jnp.float32))
    if dtype_mode == "fp32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2.0**-5 * np.abs(want).max())
    rtol = 1e-5 if dtype_mode == "fp32" else 1e-2
    np.testing.assert_allclose(float(ttotal), float(total), rtol=rtol)
    np.testing.assert_allclose(_np(tm["per_example_loss"]), np.asarray(m["per_example_loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(m["aux_loss"]), rtol=rtol)
    if cfg.n_experts:  # E·Σ mean(p)·mean(top-1) ≥ 1 per layer up to rounding
        assert float(aux) > 0.5 * cfg.n_layers
    else:
        assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_gradients_match_reference(arch, fp32_models):
    jcfg, cfg, jp, tp, batch = _setup(arch, seed=1)
    jg = _ref(jax.grad(lambda p, c, b: jmodel.loss_fn(p, c, b)[0]), jp, jcfg, _jb(batch))
    tg = convert.model_params_from_reference(jax.tree.map(np.asarray, jg), cfg, device="cpu")
    names = list(tp)
    leaves = [tp[k].requires_grad_(True) for k in names]
    total, _ = tmodel.loss_fn(dict(zip(names, leaves)), cfg, _tb(batch))
    grads = torch.autograd.grad(total, leaves)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), _np(tg[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    if cfg.n_experts:  # the router learns through the gates and the aux loss
        assert float(tg["layers.0.ffn.router"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_proxies_match_reference(arch, fp32_models):
    jcfg, cfg, jp, tp, batch = _setup(arch, seed=2)
    want = np.asarray(_ref(jmodel.proxy_features, jp, jcfg, _jb(batch)))
    einsum = tmodel.proxy_features(tp, cfg, _tb(batch)).numpy()
    twin = tmodel.proxy_features_fused(tp, cfg, _tb(batch), compute_dtype=torch.float32,
                                       impl="torch").numpy()
    assert twin.shape == (B, cfg.d_model)
    np.testing.assert_allclose(einsum, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(twin, want, rtol=1e-4, atol=1e-5)
