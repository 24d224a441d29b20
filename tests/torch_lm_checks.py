"""Whole-model checks of the port's LM against the JAX reference on the CPU,
shared by ``test_torch_xlstm.py`` and ``test_torch_frontends.py``;
``strict_jit`` also by ``test_torch_decode.py`` and ``test_torch_lm_configs.py``,
``ref_init`` by every port test that builds reference LM weights.

Same numpy batch into both packages, in the reference's
``train_batch_struct`` layout (``tokens`` or ``embeddings``, labels
(B, T) or (B, T, n_codebooks), (B, 3, T) positions under M-RoPE);
reference weights carried across by
``repro_torch.convert.model_params_from_reference``.  Reference calls
are compiled without excess precision (``strict_jit``)
and allow rank promotion (the reference's QKV-bias add, ROADMAP.md
queue 3).

Tolerances, as the port's other LM checks state them
(``test_torch_lm_configs.py``, ``test_torch_decode.py``):
  * fp32 (both packages' ``COMPUTE_DTYPE`` float32): hidden states and
    losses rtol 1e-5, atol 1e-5; proxies, after the whole model, rtol
    1e-4, atol 1e-5;
  * bf16: hidden states, prefill and decode logits |Δ| ≤ 2⁻⁵·max|ref|;
    losses rtol 1e-2; proxies |Δ| ≤ 2⁻⁵·max|W| (a few bf16 ulps of a
    convex combination of W rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.model as jmodel
from repro_torch import convert
from repro_torch.models import model as tmodel

B, T = 2, 16
STRICT = {"xla_allow_excess_precision": False}


class strict_jit:
    """``jax.jit(fn)``, compiled once per argument shapes without excess
    precision (each bf16 op rounds, as it does run op by op)."""

    def __init__(self, fn):
        self.fn, self.compiled = jax.jit(fn), {}

    def __call__(self, *args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), str(a.dtype)) for a in leaves))
        if key not in self.compiled:
            self.compiled[key] = self.fn.lower(*args).compile(compiler_options=STRICT)
        return self.compiled[key](*args)


_JIT_INIT = jax.jit(jmodel.init_params, static_argnums=1)


def ref_init(jcfg, seed=0):
    """The reference's ``init_params(PRNGKey(seed), jcfg)`` compiled as one
    program: bit for bit its op-by-op values (checked at each family's
    smoke config and the depth tests' 38–48-layer stacks) in half the time
    or less (recurrentgemma-9b's 38 smoke layers: 11.9 s op by op, 5.4 s
    compiled, on one CPU core)."""
    return _JIT_INIT(jax.random.PRNGKey(seed), jcfg)


def pair(jcfg, cfg, seed=0):
    """Reference params and the port's, converted."""
    jp = ref_init(jcfg, seed)
    return jp, convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                                   device="cpu")


def make_batch(cfg, seed=0, positions=True) -> dict:
    """A seeded numpy batch; under M-RoPE, random (B, 3, T) positions with
    three different streams (unless ``positions`` is False)."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    else:
        b["embeddings"] = (0.5 * rng.normal(size=(B, T, cfg.d_model))).astype(np.float32)
    shape = (B, T, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, T)
    b["labels"] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    b["labels"].reshape(B, T, -1)[0, -1] = cfg.vocab_size - 1  # the last real column
    b["weights"] = rng.uniform(0.2, 3.0, B).astype(np.float32)
    if cfg.mrope_sections is not None and positions:
        b["positions"] = rng.integers(0, 3 * T, (B, 3, T)).astype(np.int32)
    return b


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy()


def ref(fn, *args):
    with jax.numpy_rank_promotion("allow"):
        return strict_jit(fn)(*args)


def close(got, want, mode, what, proxy_w=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if mode == "fp32":
        tol = dict(rtol=1e-4, atol=1e-5) if proxy_w is not None else dict(rtol=1e-5, atol=1e-5)
    else:
        scale = proxy_w if proxy_w is not None else float(np.abs(want).max())
        tol = dict(rtol=0, atol=2.0**-5 * scale)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def check_training_entry_points(jcfg, cfg, jp, tp, batch, mode):
    """forward, loss_fn, proxy_features and proxy_features_fused (the
    port's plain twin against the reference's Pallas kernel in interpret
    mode) in ``mode`` ('fp32' or 'bf16'; the caller sets COMPUTE_DTYPE)."""
    jcd = jmodel.COMPUTE_DTYPE
    tcd = tmodel.COMPUTE_DTYPE
    (jh, _), (jtotal, jm), jpf, jpff = ref(
        lambda p, b: (jmodel.forward(p, jcfg, b), jmodel.loss_fn(p, jcfg, b),
                      jmodel.proxy_features(p, jcfg, b),
                      jmodel.proxy_features_fused(p, jcfg, b, compute_dtype=jcd,
                                                  interpret=True)), jp, jb(batch))
    hidden, aux = tmodel.forward(tp, cfg, tb(batch))
    assert hidden.dtype == tcd and tuple(hidden.shape) == (B, T, cfg.d_model)
    assert float(aux) == 0.0
    close(_np(hidden), jh.astype(jnp.float32), mode, "hidden")
    total, m = tmodel.loss_fn(tp, cfg, tb(batch))
    rtol = 1e-5 if mode == "fp32" else 1e-2
    np.testing.assert_allclose(float(total), float(jtotal), rtol=rtol)
    np.testing.assert_allclose(_np(m["per_example_loss"]), np.asarray(jm["per_example_loss"]),
                               rtol=rtol)
    wmax = float(tmodel.unembed_matrix(tp).abs().max())
    einsum = tmodel.proxy_features(tp, cfg, tb(batch))
    twin = tmodel.proxy_features_fused(tp, cfg, tb(batch), compute_dtype=tcd, impl="torch")
    assert tuple(twin.shape) == (B, cfg.d_model) and twin.dtype == torch.float32
    close(_np(einsum), jpf, mode, "proxy_features", proxy_w=wmax)
    close(_np(twin), jpff, mode, "proxy_features_fused", proxy_w=wmax)


def check_serving_entry_points(jcfg, cfg, jp, tp, batch):
    """bf16 prefill and a teacher-forced ``decode_step`` over the batch's
    tokens or embeddings (text positions: the default, every M-RoPE
    stream equal), step by step against the reference's."""
    key = "tokens" if cfg.frontend == "tokens" else "embeddings"
    x = batch[key]
    step = strict_jit(lambda p, s, b: jmodel.decode_step(p, jcfg, s, b))
    js = jmodel.init_serve_state(jcfg, B, T)
    ts = tmodel.init_serve_state(cfg, B, T, "cpu")
    shape = (B, cfg.n_codebooks, cfg.padded_vocab) if cfg.n_codebooks > 1 else (
        B, cfg.padded_vocab)
    with torch.inference_mode(), jax.numpy_rank_promotion("allow"):
        for t in range(T):
            jl, js = step(jp, js, {key: jnp.asarray(x[:, t:t + 1])})
            tl, ts = tmodel.decode_step(tp, cfg, ts, {key: torch.as_tensor(x[:, t:t + 1])})
            assert tl.dtype == torch.float32 and tuple(tl.shape) == shape
            close(_np(tl), jl, "bf16", f"decode step {t}")
        assert ts["pos"] == T == int(js["pos"])
        _, jlast = ref(lambda p, b: jmodel.prefill(p, jcfg, b), jp, {key: jnp.asarray(x)})
        hidden, tlast = tmodel.prefill(tp, cfg, {key: torch.as_tensor(x)})
    assert tuple(hidden.shape) == (B, T, cfg.d_model) and tuple(tlast.shape) == shape
    close(_np(tlast), jlast, "bf16", "prefill")
    return ts
