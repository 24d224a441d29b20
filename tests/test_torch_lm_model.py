"""The port's dense LM (repro_torch.models) against the JAX reference on the CPU.

Same numpy inputs into both; reference weights from ``repro.models.init_params``
carried across by ``repro_torch.convert.model_params_from_reference``.

Tolerances.  Each check runs twice:
  * fp32 (both packages' ``COMPUTE_DTYPE`` set to float32 for the test):
    rtol 1e-5, atol 1e-5 — the algorithms agree and only the matrix
    products' summation order differs (~1e-6 relative at these widths);
  * bf16 (the production dtype): |Δ| ≤ 2⁻⁵·max|ref| (8 bf16 ulps of the
    largest value), since each framework rounds its bf16 products and
    elementwise results at slightly different points and a few ulps
    accumulate over the two layers; losses are fp32 means of bf16 logits:
    rtol 1e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig, validate_config
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

# 2 layers, d_model 64, 4 heads over 2 kv heads, vocab 250 padded to 256
SMALL = dict(
    name="tiny-qwen3", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab_size=250, qk_norm=True,
    rope_theta=1e6, logit_chunk=8,
)
B, T = 3, 16


def _cfgs(**kw):
    return JModelConfig(**{**SMALL, **kw}), ModelConfig(**{**SMALL, **kw})


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels[0, -1] = cfg.vocab_size - 1  # the last real vocab column
    w = rng.uniform(0.2, 3.0, B).astype(np.float32)
    return {"tokens": toks, "labels": labels, "weights": w}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _params(jcfg, cfg, seed=0):
    jp = ref_init(jcfg, seed)
    return jp, convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(params=["fp32", "bf16"])
def dtype_mode(request, monkeypatch):
    if request.param == "fp32":
        monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    return request.param


def _close(got, want, mode):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if mode == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-5 * float(np.abs(want).max()))


def _np(t):
    return t.detach().float().numpy()


def test_qwen3_config_is_the_reference():
    from repro.configs.registry import get_config as jget

    ref = dataclasses.asdict(jget("qwen3-1.7b"))
    got = dataclasses.asdict(get_config("qwen3-1.7b"))
    assert got == ref
    cfg = get_config("qwen3-1.7b")
    assert cfg.param_count() == 2_031_739_904 == jget("qwen3-1.7b").param_count()
    assert cfg.padded_vocab == 151_936 and cfg.layer_kinds == ("attn",) * 28
    validate_config(cfg)


@pytest.mark.parametrize("bad", [dict(frontend="embeddings"),
                                 dict(block_pattern=("mlstm", "attn")),
                                 dict(n_codebooks=2)])
def test_unported_families_raise(bad):
    """The embeddings frontend, an mLSTM pattern and codebook heads, once
    refused, now build; what the reference itself rejects (an unknown
    remat policy or layer kind) still raises."""
    cfg = ModelConfig(**{**SMALL, **bad})
    validate_config(cfg)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    assert ("embed" in params) == (cfg.frontend == "tokens")
    want = (cfg.padded_vocab, cfg.d_model)
    assert tuple(params["unembed"].shape) == (
        want if cfg.n_codebooks == 1 else (cfg.n_codebooks, *want))
    assert set(params) == set(tmodel.param_shapes(cfg))
    with pytest.raises(ValueError, match="remat policy"):
        validate_config(dataclasses.replace(cfg, remat_policy="some"))
    with pytest.raises(ValueError, match="layer kinds"):
        tmodel.init_params(dataclasses.replace(cfg, block_pattern=("mamba",)),
                           torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_layer_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    for jf, tf in ((jlayers.rms_norm, tlayers.rms_norm), (jlayers.layer_norm, tlayers.layer_norm)):
        want = np.asarray(jf({"scale": jnp.asarray(s)}, jx).astype(jnp.float32))
        got = _np(tf(torch.as_tensor(s), tx))
        _close(got, want, "fp32" if dtype == "float32" else "bf16")


def test_rope_is_half_split():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 5, (2, 1))
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = _np(tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # half-split: the first half pairs with the second half, not neighbours
    inv = 1.0 / (1e6 ** (np.arange(0, 16, 2) / 16))
    ang = pos[0, 1] * inv[0]
    x1, x2 = x[0, 1, 0, 0], x[0, 1, 0, 8]
    np.testing.assert_allclose(got[0, 1, 0, 0], x1 * np.cos(ang) - x2 * np.sin(ang), rtol=1e-5)


@pytest.mark.parametrize("kv,qk_norm,bias", [(2, True, False), (4, False, False), (1, True, True)])
@pytest.mark.parametrize("path", ["dense", "blockwise"])
def test_attention_matches_reference(kv, qk_norm, bias, path):
    d, H, hd = 32, 4, 8
    threshold = 8 if path == "blockwise" else 8192
    jc = jattn.AttentionConfig(d_model=d, n_heads=H, n_kv_heads=kv, d_head=hd,
                               qkv_bias=bias, qk_norm=qk_norm, rope_theta=1e4,
                               blockwise_threshold=threshold, chunk_q=4, chunk_kv=8)
    tc = tattn.AttentionConfig(d_model=d, n_heads=H, n_kv_heads=kv, d_head=hd,
                               qkv_bias=bias, qk_norm=qk_norm, rope_theta=1e4,
                               blockwise_threshold=threshold, chunk_q=4, chunk_kv=8)
    jp = jattn.init_attention(jax.random.PRNGKey(3), jc)
    if bias:
        rng = np.random.default_rng(4)
        jp = {**jp, **{k: jnp.asarray(rng.normal(size=jp[k].shape).astype(np.float32))
                       for k in ("bq", "bk", "bv")}}
    flat = {}
    for k, v in jp.items():
        if isinstance(v, dict):
            flat[f"{k}.scale"] = torch.as_tensor(np.array(v["scale"]))
        else:
            flat[k] = torch.as_tensor(np.array(v))
    x = np.random.default_rng(5).normal(size=(2, 16, d)).astype(np.float32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    with jax.numpy_rank_promotion("allow"):  # the reference's QKV-bias add
        want = np.asarray(jattn.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos)))
    got = _np(tattn.attention(flat, tc, torch.as_tensor(x), torch.as_tensor(pos)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_blockwise_equals_dense_in_the_port():
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 24, 4, 8)).astype(np.float32))
               for _ in range(3))
    cfg = tattn.AttentionConfig(d_model=32, n_heads=4, n_kv_heads=4, d_head=8,
                                chunk_q=8, chunk_kv=4)
    dense = tattn._dense_attention(q, k, v, 0.35)
    block = tattn._blockwise_attention(q, k, v, 0.35, cfg)
    np.testing.assert_allclose(_np(block), _np(dense), rtol=1e-5, atol=1e-6)


def test_forward_matches_reference(dtype_mode):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, cfg)
    batch = _batch(cfg)
    want, _ = jmodel.forward(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = tmodel.forward(tp, cfg, _tb(batch))
    assert got.dtype == tmodel.COMPUTE_DTYPE and float(aux) == 0.0
    _close(_np(got), np.asarray(want.astype(jnp.float32)), dtype_mode)


def test_blockwise_forward_matches_reference(dtype_mode):
    jcfg, cfg = _cfgs(blockwise_threshold=8, attn_chunk_q=4, attn_chunk_kv=8)
    jp, tp = _params(jcfg, cfg, seed=1)
    batch = _batch(cfg, seed=1)
    want, _ = jmodel.forward(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = tmodel.forward(tp, cfg, _tb(batch))
    _close(_np(got), np.asarray(want.astype(jnp.float32)), dtype_mode)


@pytest.mark.parametrize("weights", [True, False])
def test_weighted_loss_matches_reference(dtype_mode, weights):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, cfg, seed=2)
    batch = _batch(cfg, seed=2)
    if not weights:
        batch.pop("weights")
    total, m = jmodel.loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    ttotal, tm = tmodel.loss_fn(tp, cfg, _tb(batch))
    rtol = 1e-5 if dtype_mode == "fp32" else 1e-2
    np.testing.assert_allclose(float(ttotal), float(total), rtol=rtol)
    np.testing.assert_allclose(_np(tm["per_example_loss"]), np.asarray(m["per_example_loss"]),
                               rtol=rtol)
    # γ-weighted mean: Σ per_example·w / max(Σw, 1e-6)
    w = batch.get("weights", np.ones(B, np.float32))
    pe = _np(tm["per_example_loss"])
    np.testing.assert_allclose(float(tm["loss"]), (pe * w).sum() / max(w.sum(), 1e-6), rtol=1e-6)


def test_loss_gradients_match_reference(monkeypatch):
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, cfg, seed=3)
    batch = _batch(cfg, seed=3)
    jg = jax.grad(lambda p: jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    tg = convert.model_params_from_reference(jax.tree.map(np.asarray, jg), cfg, device="cpu")
    names = list(tp)
    leaves = [tp[k].requires_grad_(True) for k in names]
    total, _ = tmodel.loss_fn(dict(zip(names, leaves)), cfg, _tb(batch))
    grads = torch.autograd.grad(total, leaves)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), _np(tg[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_padded_vocab_columns_carry_no_mass():
    _, cfg = _cfgs()
    tp = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    assert tp["unembed"].shape == (cfg.padded_vocab, cfg.d_model) == (256, 64)
    batch = _tb(_batch(cfg))
    base = tmodel.loss_fn(tp, cfg, batch)[0]
    tp["unembed"][cfg.vocab_size:] = 100.0  # padded rows: no effect
    np.testing.assert_allclose(float(tmodel.loss_fn(tp, cfg, batch)[0]), float(base), rtol=1e-6)


def test_remat_does_not_change_values():
    _, cfg = _cfgs()
    tp = tmodel.init_params(cfg, torch.Generator().manual_seed(1))
    batch = _tb(_batch(cfg))
    out = {}
    for policy in ("nothing", "full"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        names = list(tp)
        leaves = [tp[k].detach().requires_grad_(True) for k in names]
        loss = tmodel.loss_fn(dict(zip(names, leaves)), c, batch)[0]
        out[policy] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    assert out["nothing"][0] == out["full"][0]
    for a, b in zip(out["nothing"][1], out["full"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
