"""The port's MoE FFN (repro_torch.models.moe) on the CPU: the reference's
properties (``tests/test_moe.py``) and parity with ``repro.models.moe``.

Parity runs both on the same numpy inputs.  Reference weights come from a
one-layer MoE model of ``repro.models.init_params`` carried across by
``repro_torch.convert.model_params_from_reference`` (layer 0's
``ffn.*``).

Tolerances:
  * fp32: y within rtol 1e-5 (atol 1e-6 for values near 0), aux within
    1e-6 — the same arithmetic in another summation order; the top-k
    routes and the set of dropped (token, choice) pairs equal;
  * bf16: the router logits are rounded to bf16 after a product whose
    fp32 sum order differs between XLA and torch, so a logit can land one
    bf16 ulp away.  Routes are equal except at tokens whose K-th and
    (K+1)-th reference logits lie within one bf16 ulp; y is compared on
    the other tokens, to 2⁻⁶·max|y| (4 bf16 ulps of the largest value:
    each framework rounds the expert products and the gate weighting to
    bf16 at its own points);
  * gradients (fp32) against ``jax.grad``: rtol 1e-4, atol 1e-6, as
    ``test_torch_lm_model.py`` holds the model's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.models import moe as jmoe
from repro.models.blocks import _moe_cfg
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import layer_params, moe_config
from repro_torch.models.config import ModelConfig
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

BF16_ULP = 2.0**-7  # spacing of bf16 values in [1, 2)
jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=1)  # one compile per config


def _np(t):
    return t.detach().float().numpy()


def _pair(seed=0, **moe):
    """(reference ffn params, port ffn params, reference MoEConfig, port
    MoEConfig) of a one-layer MoE model seeded by ``seed``."""
    fields = {**dict(name="tiny-moe", family="moe", n_layers=1, d_model=D, n_heads=4,
                     n_kv_heads=2, d_ff=48, vocab_size=64, n_experts=4, top_k=2), **moe}
    jcfg, cfg = JModelConfig(**fields), ModelConfig(**fields)
    jp = jax.tree.map(np.asarray, ref_init(jcfg, seed))
    tp = convert.model_params_from_reference(jp, cfg, device="cpu")
    jffn = {k: jnp.asarray(v[0]) for k, v in jp["stack"]["scanned"][0]["ffn"].items()}
    tffn = {k[len("ffn."):]: v for k, v in layer_params(tp, 0).items() if k.startswith("ffn.")}
    assert set(jffn) == set(tffn)
    return jffn, tffn, _moe_cfg(jcfg), moe_config(cfg)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_routes(jp, jcfg, x):
    """The reference's top-k expert ids and kept (token, choice) pairs,
    recomputed from its own router product (moe.py's steps 1–2)."""
    logits = jnp.einsum("gsd,de->gse", x, jp["router"].astype(x.dtype)).astype(jnp.float32)
    _, eidx = jax.lax.top_k(logits, jcfg.top_k)
    eidx = np.asarray(eidx)
    G, S, K = eidx.shape
    C = tmoe.moe_capacity(jcfg, S)
    flat = eidx.reshape(G, S * K)
    keep = np.zeros_like(flat, dtype=bool)
    for g in range(G):
        seen = np.zeros(jcfg.n_experts, np.int64)
        for i, e in enumerate(flat[g]):
            keep[g, i] = seen[e] < C
            seen[e] += 1
    return np.asarray(logits), eidx, keep


# -- the reference's properties (tests/test_moe.py) ---------------------------


def _init(cfg, seed=0):
    return tmoe.init_moe(cfg, torch.Generator().manual_seed(seed), "cpu")


def _randn(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_single_expert_equals_dense():
    """E=1, k=1 with ample capacity reduces to an ordinary gated FFN."""
    cfg = tmoe.MoEConfig(d_model=16, d_ff_expert=32, n_experts=1, top_k=1, capacity_factor=4.0)
    params = _init(cfg)
    x = _randn((2, 8, 16), 1)
    y, aux = tmoe.moe_ffn(params, cfg, x)
    g, u = torch.chunk(x @ params["experts_in"][0], 2, dim=-1)
    want = (torch.nn.functional.silu(g) * u) @ params["experts_out"][0]
    torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-5)
    assert float(aux) == 1.0  # perfectly "balanced" single expert


def test_no_capacity_drop_with_large_factor():
    """With capacity ≥ tokens·k/E·E every token is routed: output nonzero."""
    cfg = tmoe.MoEConfig(d_model=8, d_ff_expert=16, n_experts=4, top_k=2, capacity_factor=8.0)
    y, _ = tmoe.moe_ffn(_init(cfg), cfg, _randn((1, 32, 8), 1))
    assert float(torch.linalg.norm(y[0], dim=-1).min()) > 0.0


def test_capacity_drops_tokens():
    """Tiny capacity forces drops: some tokens get zero expert output."""
    cfg = tmoe.MoEConfig(d_model=8, d_ff_expert=16, n_experts=2, top_k=1, capacity_factor=0.12)
    y, _ = tmoe.moe_ffn(_init(cfg), cfg, _randn((1, 64, 8), 2))
    norms = _np(torch.linalg.norm(y[0], dim=-1))
    assert (norms < 1e-6).sum() > 0  # dropped tokens exist
    assert (norms > 1e-6).sum() > 0  # routed tokens exist


def test_shared_experts_always_on():
    cfg = tmoe.MoEConfig(d_model=8, d_ff_expert=16, n_experts=2, top_k=1,
                         capacity_factor=0.01, n_shared_experts=1)
    y, _ = tmoe.moe_ffn(_init(cfg), cfg, _randn((1, 32, 8), 2))
    # with ~all tokens dropped by routed experts, the shared path still fires
    assert (_np(torch.linalg.norm(y[0], dim=-1)) > 1e-6).all()


def test_group_independence():
    """Groups dispatch independently: permuting group order permutes output."""
    cfg = tmoe.MoEConfig(d_model=8, d_ff_expert=16, n_experts=4, top_k=2, capacity_factor=2.0)
    params = _init(cfg)
    x = _randn((4, 16, 8), 3)
    y, _ = tmoe.moe_ffn(params, cfg, x)
    y_perm, _ = tmoe.moe_ffn(params, cfg, x.flip(0))
    torch.testing.assert_close(y.flip(0), y_perm, rtol=1e-5, atol=1e-6)


def test_aux_loss_favors_balance():
    """Aux loss equals ~1 under a uniform router (every logit tied: the
    top-1 expert is expert 0 for every token, as the reference picks)."""
    cfg = tmoe.MoEConfig(d_model=8, d_ff_expert=16, n_experts=4, top_k=1, capacity_factor=2.0)
    params = _init(cfg)
    params["router"] = torch.zeros_like(params["router"])  # uniform logits
    _, aux = tmoe.moe_ffn(params, cfg, _randn((1, 256, 8), 1))
    assert 0.9 <= float(aux) <= 1.6


def test_grad_flows_through_router():
    cfg = tmoe.MoEConfig(d_model=8, d_ff_expert=16, n_experts=4, top_k=2, capacity_factor=2.0)
    params = {k: v.requires_grad_(True) for k, v in _init(cfg).items()}
    y, aux = tmoe.moe_ffn(params, cfg, _randn((1, 16, 8), 1))
    names = list(params)
    grads = torch.autograd.grad(torch.sum(y**2) + 0.01 * aux, [params[k] for k in names])
    g = dict(zip(names, grads))
    assert float(torch.linalg.norm(g["router"])) > 0
    assert all(bool(torch.isfinite(t).all()) for t in grads)


# -- parity with the reference ----------------------------------------------

# Config fields: gated SwiGLU with drops, capacity to spare, shared experts,
# the non-gated relu² FFN with drops, and top-1.  All at x (G, S, D):
# one shape, so the reference's eager ops compile once.
CASES = {
    "drops": dict(capacity_factor=0.5),
    "no_drops": dict(capacity_factor=4.0),
    "shared": dict(n_shared_experts=2, capacity_factor=1.0),
    "relu2": dict(activation="relu2", gated_ffn=False, capacity_factor=0.75),
    "top1": dict(top_k=1, capacity_factor=1.0),
}
G, S, D = 3, 32, 32


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference_fp32(case):
    jp, tp, jcfg, cfg = _pair(seed=len(case), **CASES[case])
    x = _x((G, S, D), seed=len(case))
    want_y, want_aux = jmoe_ffn(jp, jcfg, jnp.asarray(x))
    got_y, got_aux = tmoe.moe_ffn(tp, cfg, torch.as_tensor(x))
    _, eidx, keep = _ref_routes(jp, jcfg, jnp.asarray(x))
    _, got_eidx, _ = tmoe.moe_route(tp, cfg, torch.as_tensor(x))
    np.testing.assert_array_equal(got_eidx.numpy(), eidx)
    _, got_keep = tmoe.moe_slots(got_eidx, cfg.n_experts, tmoe.moe_capacity(cfg, S))
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    if case in ("drops", "relu2", "top1"):
        assert not keep.all()  # the case drops pairs
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["no_drops", "shared"])
def test_moe_ffn_matches_reference_bf16(case):
    jp, tp, jcfg, cfg = _pair(seed=len(case), **CASES[case])
    x = _x((G, S, D), seed=len(case) + 1)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    want_y, want_aux = jmoe_ffn(jp, jcfg, xj)
    got_y, got_aux = tmoe.moe_ffn(tp, cfg, xt)
    logits, eidx, _ = _ref_routes(jp, jcfg, xj)
    _, got_eidx, _ = tmoe.moe_route(tp, cfg, xt)
    K = cfg.top_k
    top = -np.sort(-logits, axis=-1)
    near = np.abs(top[..., K - 1] - top[..., K]) <= BF16_ULP * np.abs(top[..., K - 1])
    same = (got_eidx.numpy() == eidx).all(axis=-1)
    assert (same | near).all(), "a route differs away from a one-ulp near-tie"
    want = np.asarray(want_y.astype(jnp.float32))
    tol = 2.0**-6 * float(np.abs(want).max())
    np.testing.assert_allclose(_np(got_y)[same], want[same], rtol=0, atol=tol)
    assert got_y.dtype == torch.bfloat16
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


def test_exact_router_ties_go_to_the_lower_expert():
    """Two identical router columns: every tie between experts 1 and 3
    goes to 1, in the reference's order, at top-1 and top-2."""
    for top_k in (1, 2):
        jp, tp, jcfg, cfg = _pair(seed=5, top_k=top_k, capacity_factor=4.0)
        router = np.asarray(jp["router"]).copy()
        router[:, 3] = router[:, 1]
        jp["router"], tp["router"] = jnp.asarray(router), torch.as_tensor(router)
        x = _x((G, S, D), seed=6)
        _, eidx, _ = _ref_routes(jp, jcfg, jnp.asarray(x))
        _, got, _ = tmoe.moe_route(tp, cfg, torch.as_tensor(x))
        np.testing.assert_array_equal(got.numpy(), eidx)
        assert (eidx[..., 0] == 1).any() and not (eidx[..., 0] == 3).any()
        want_y, want_aux = jmoe_ffn(jp, jcfg, jnp.asarray(x))
        got_y, got_aux = tmoe.moe_ffn(tp, cfg, torch.as_tensor(x))
        np.testing.assert_allclose(_np(got_y), np.asarray(want_y), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["drops", "shared"])
def test_moe_gradients_match_reference(case):
    jp, tp, jcfg, cfg = _pair(seed=7, **CASES[case])
    x = _x((G, S, D), seed=8)
    r = _x((G, S, D), seed=9)  # a fixed direction for the output

    def jloss(p, x):
        y, aux = jmoe_ffn(p, jcfg, x)
        return jnp.sum(y * r) + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    names = list(tp)
    leaves = [tp[k].requires_grad_(True) for k in names]
    xt = torch.as_tensor(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(dict(zip(names, leaves)), cfg, xt)
    grads = torch.autograd.grad(torch.sum(y * torch.as_tensor(r)) + 0.01 * aux, [*leaves, xt])
    np.testing.assert_allclose(_np(grads[-1]), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), np.asarray(jg[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(np.abs(np.asarray(jg["router"])).max()) > 0


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_remat_recompute_routes_identically(arch):
    """Remat 'nothing' (each layer recomputed in the backward under
    ``torch.utils.checkpoint``) gives the loss, aux and gradients of
    'full' bit for bit: the recompute routes every token as the forward
    did."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import model as tmodel

    cfg = smoke_config(arch)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    out = {}
    for policy in ("nothing", "full"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        total, m = tmodel.loss_fn(dict(zip(names, leaves)), c, batch)
        out[policy] = (float(total.detach()), float(m["aux_loss"].detach()),
                       torch.autograd.grad(total, leaves))
    assert out["nothing"][:2] == out["full"][:2] and out["full"][1] > 0
    for a, b in zip(out["nothing"][2], out["full"][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
