"""LM gradient proxies: ``ce_proxy``'s plain twin, the chunked einsum path,
and the model-level proxies, against the JAX reference on the CPU.

The reference's ``ce_proxy`` runs its Pallas kernel in interpret mode
(``repro.kernels.ops.ce_proxy(..., interpret=True)``), as
``tests/test_proxy.py`` runs it.  The port takes the unembedding
vocab-major, so it receives ``W.T`` of the reference's (D, V) matrix.

Tolerances, stated with their reason:
  * fp32 twin against the fp32 reference kernel and the dense oracle: rtol
    1e-5, atol 1e-6 — the same arithmetic in another summation order; at
    the wide edge shapes (D ≥ 250: logits of ~20 summed over D terms in
    another order, an absolute error of up to 4·√D·ε₃₂·max|h|·max|W| that
    moves p by as much relative, and g by that times max|W|) rtol 1e-4,
    atol 4·√D·ε₃₂·max|h|·max|W|²;
  * bf16 (both products in bf16, fp32 accumulation): atol 2⁻⁸·max|W| — g
    is a convex combination of W rows minus a W row, and a p value whose
    fp32 exp differs in the last bit can round to the neighbouring bf16
    value (one bf16 ulp, 2⁻⁸ relative, of a term bounded by max|W|);
  * kernel path against the einsum path (fp32): rtol 1e-4, atol 1e-5, as
    ``tests/test_proxy.py`` holds the reference's two paths; in bf16 the
    einsum path also rounds its logits and its (p − y) to bf16 where the
    kernel keeps fp32, so: atol 2⁻⁵·max|W|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.core import proxy as jproxy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.core import proxy as tproxy
from repro_torch.kernels import ops, ref
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
from repro_torch.train.train_step import make_select_step
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

SHAPES = [  # (T, D, V, valid_v)
    (8, 8, 16, None),     # block-aligned
    (10, 12, 20, 17),     # ragged T, D and V, padded vocab
    (33, 16, 100, 97),    # T and V straddle several blocks
    (16, 8, 129, 129),    # V one past a block boundary
    # the CUDA kernel's tiling edges (128-token clusters, 256-column CTAs,
    # 64-row vocab blocks), held to the reference at the shapes chip_smoke.py
    # holds the kernel to this twin
    (1, 2048, 4099, 4097),     # one token, the widest D
    (129, 2040, 4099, 4097),   # D not a multiple of 256, ragged T and V
    (37, 250, 3001, 2999),     # D % 8 != 0: the staged route
    # past the 2048 columns of an 8-CTA cluster (the kernel's second route,
    # 512 columns a CTA): 2,304 and qwen2-7b's 3,584, with ragged T, V and
    # valid_v
    (9, 2304, 130, 129),
    (5, 3584, 300, 297),
]
EPS32 = float(np.finfo(np.float32).eps)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(T, D, V, valid_v, seed):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(T, D)) * 1.5).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)  # the reference's (D, V)
    y = rng.integers(0, valid_v or V, T).astype(np.int32)
    y[-1] = (valid_v or V) - 1  # a label at the last valid column
    return h, w, y


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,D,V,valid_v", SHAPES)
def test_ce_proxy_twin_matches_reference_kernel(T, D, V, valid_v, dtype):
    jd, td = DTYPES[dtype]
    h, w, y = _inputs(T, D, V, valid_v, seed=T * 100 + V)
    bt, bv = (8, 16) if V < 1000 else (128, 512)  # interpret mode: few grid steps
    want = np.asarray(jops.ce_proxy(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                                    block_t=bt, block_v=bv, valid_v=valid_v,
                                    compute_dtype=jd, interpret=True))
    got = ops.ce_proxy(_t(h), _t(w.T), _t(y), valid_v=valid_v, compute_dtype=td).numpy()
    assert got.shape == (T, D) and got.dtype == np.float32
    if dtype == "fp32" and D <= 16:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    elif dtype == "fp32":  # logit rounding over D terms, moved into p and g
        atol = 4.0 * np.sqrt(D) * EPS32 * np.abs(h).max() * np.abs(w).max() ** 2
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-8 * np.abs(w).max())


def test_ce_proxy_twin_matches_dense_oracle():
    h, w, y = _inputs(40, 24, 300, None, seed=3)
    want = np.asarray(jref.ce_proxy_ref(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y)))
    for got in (ops.ce_proxy(_t(h), _t(w.T), _t(y)), ref.ce_proxy_ref(_t(h), _t(w.T), _t(y))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ce_proxy_twin_chunking_is_invariant():
    from repro_torch.kernels import ce_proxy as kce

    h, w, y = _inputs(50, 16, 64, 60, seed=4)
    a = kce.ce_proxy_torch(_t(h), _t(w.T), _t(y), 60, torch.float32, chunk=7)
    b = kce.ce_proxy_torch(_t(h), _t(w.T), _t(y), 60, torch.float32, chunk=1024)
    # row-wise arithmetic; only the BLAS kernel chosen per row count differs
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_ce_proxy_bf16_close_to_fp32():
    h, w, y = _inputs(32, 16, 64, None, seed=7)
    f32 = ops.ce_proxy(_t(h), _t(w.T), _t(y))
    bf16 = ops.ce_proxy(_t(h), _t(w.T), _t(y), compute_dtype=torch.bfloat16)
    # bf16 rounding of h, W and p: a few bf16 ulps of the largest |W|
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), rtol=0, atol=2.0**-5 * np.abs(w).max())


def test_ce_proxy_rejects_bad_arguments():
    h, w, y = _inputs(8, 8, 16, None, seed=0)
    with pytest.raises(ValueError, match="valid_v"):
        ops.ce_proxy(_t(h), _t(w.T), _t(y), valid_v=17)
    with pytest.raises(ValueError, match="compute_dtype"):
        ops.ce_proxy(_t(h), _t(w.T), _t(y), compute_dtype=torch.float16)


def test_bf16_kernel_refuses_d_past_its_width():
    """The name is kept from when the bf16 kernel refused D > 2048; the test
    now holds that no width limit exists.  The kernel has a route for every
    D: at qwen2-7b's D = 3,584 it refuses CPU tensors only (the "takes CUDA
    tensors" ValueError, never a width limit), before any launch."""
    from repro_torch.kernels import ce_proxy as kce

    D = 3584
    h, w = torch.zeros(2, D, dtype=torch.bfloat16), torch.zeros(4, D, dtype=torch.bfloat16)
    y = torch.zeros(2, dtype=torch.int32)
    before = ops.LAUNCHES["ce_proxy"]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kce.ce_proxy_cuda(h, w, y, 4)
    assert ops.LAUNCHES["ce_proxy"] == before
    # the plain twin takes any width
    g = ops.ce_proxy(h, w, y, compute_dtype=torch.bfloat16)
    assert g.shape == (2, D) and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("T,D,V,valid_v", SHAPES)
def test_twin_matches_lm_unembed_input_proxy(T, D, V, valid_v):
    """The kernel's contract and the chunked einsum path compute the same
    §3.4 quantity (token mean), padded vocab included."""
    h, w, y = _inputs(T, D, V, valid_v, seed=T + D)
    got = ops.ce_proxy(_t(h), _t(w.T), _t(y), valid_v=valid_v).numpy().mean(0)
    want = np.asarray(jproxy.lm_unembed_input_proxy(
        jnp.asarray(h)[None], jnp.asarray(w), jnp.asarray(y)[None], chunk=5, valid_v=valid_v))[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True])
def test_lm_unembed_input_proxy_matches_reference(dtype, masked):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(11)
    B, T, D, V = 3, 13, 16, 40
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)
    y = rng.integers(0, 37, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    want = np.asarray(jproxy.lm_unembed_input_proxy(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), jm, chunk=5, valid_v=37,
        compute_dtype=jd))
    got = tproxy.lm_unembed_input_proxy(_t(h), _t(w.T), _t(y), tm, chunk=5, valid_v=37,
                                        compute_dtype=td).numpy()
    if dtype == "fp32" and D <= 16:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    elif dtype == "fp32":  # logit rounding over D terms, moved into p and g
        atol = 4.0 * np.sqrt(D) * EPS32 * np.abs(h).max() * np.abs(w).max() ** 2
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-8 * np.abs(w).max())


def test_exact_per_example_grads_match_reference():
    rng = np.random.default_rng(12)
    xs = rng.normal(size=(6, 5)).astype(np.float32)
    ys = rng.integers(0, 2, 6).astype(np.float32)
    p = {"w": rng.normal(size=5).astype(np.float32), "b": np.float32(0.3) * np.ones(1, np.float32)}

    def jloss(params, x, y):
        z = x @ params["w"] + params["b"][0]
        return jnp.logaddexp(0.0, z) - y * z

    def tloss(params, x, y):
        z = x @ params["w"] + params["b"][0]
        return torch.logaddexp(torch.zeros(()), z) - y * z

    want = np.asarray(jproxy.exact_per_example_grads(
        jloss, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xs), jnp.asarray(ys)))
    got = tproxy.exact_per_example_grads(tloss, {k: _t(v) for k, v in p.items()}, _t(xs), _t(ys))
    assert got.shape == (6, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# -- model-level proxies -----------------------------------------------------

SMALL = dict(
    name="tiny-qwen3", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab_size=250, qk_norm=True,
    rope_theta=1e6, logit_chunk=8,
)


def _model(seed=0):
    jcfg, cfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    jp = ref_init(jcfg, seed)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 250, (3, 16)).astype(np.int32),
             "labels": rng.integers(0, 250, (3, 16)).astype(np.int32)}
    batch["labels"][1, 3] = 249
    return jcfg, cfg, jp, tp, batch


@pytest.fixture
def fp32_models(monkeypatch):
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)


def test_model_proxies_match_reference(fp32_models):
    jcfg, cfg, jp, tp, batch = _model()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    want = np.asarray(jmodel.proxy_features(jp, jcfg, jb))
    want_fused = np.asarray(jmodel.proxy_features_fused(
        jp, jcfg, jb, compute_dtype=jnp.float32, interpret=True))
    got = tmodel.proxy_features(tp, cfg, tb).numpy()
    got_fused = tmodel.proxy_features_fused(tp, cfg, tb, compute_dtype=torch.float32,
                                            impl="torch").numpy()
    assert got.shape == got_fused.shape == (3, 64)
    # hidden states pass through the whole model: the model-level fp32 tolerance
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_fused, want_fused, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_fused, got, rtol=1e-4, atol=1e-5)


def test_fused_proxy_matches_einsum_proxy_in_bf16():
    _, cfg, _, tp, batch = _model(seed=1)
    tb = {k: _t(v) for k, v in batch.items()}
    einsum = tmodel.proxy_features(tp, cfg, tb).numpy()
    fused = tmodel.proxy_features_fused(tp, cfg, tb).numpy()
    wmax = float(tp["unembed"].abs().max())
    np.testing.assert_allclose(fused, einsum, rtol=0, atol=2.0**-5 * wmax)


def test_select_step_dispatch():
    _, cfg, _, tp, batch = _model(seed=2)
    tb = {k: _t(v) for k, v in batch.items()}
    auto = make_select_step(cfg, "auto")(tp, tb)
    einsum = make_select_step(cfg, "einsum")(tp, tb)
    torch.testing.assert_close(auto, einsum, rtol=0, atol=0)  # 'auto' → einsum on the CPU
    plain = make_select_step(cfg, "torch")(tp, tb)
    fused = tmodel.proxy_features_fused(tp, cfg, tb, impl="torch")
    torch.testing.assert_close(plain, fused, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        make_select_step(cfg, "cuda")(tp, tb)
    with pytest.raises(ValueError, match="proxy_impl"):
        make_select_step(cfg, "pallas")
    assert convert.PROXY_IMPL_FROM_REFERENCE["pallas"] == "cuda"
