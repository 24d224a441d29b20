"""The port's KV-cache decode, windowed attention, prefill and serve state
(repro_torch.models) against the JAX reference on the CPU.

Same numpy inputs into both; reference weights carried across by
``repro_torch.convert.model_params_from_reference``, reference serve
states by ``convert.serve_state_from_reference``.  Reference calls run under
``jax.jit`` and ``jax.numpy_rank_promotion("allow")`` (the reference's
QKV-bias add, ROADMAP.md queue 3).  The whole-model ones are compiled
with ``xla_allow_excess_precision=False``
(``torch_lm_checks.strict_jit``): by default
XLA keeps fp32 inside a fusion where the reference's ops, run one by
one, and the port's round to bf16 after each op.  That fusion alone
moves the Griffin smoke model's bf16 prefill logits by 3.4% of their
largest value against the port; compiled strictly, the reference's
Griffin decode logits equal the port's to 2e-8 and its prefill to 0.3%.

Tolerances:
  * attention and decode attention in fp32 (caches bf16 in both, as the
    reference keeps them): rtol 1e-4, atol 1e-5;
  * ``decode_step`` and ``prefill`` logits in bf16, the production dtype:
    |Δ| ≤ 2⁻⁵·max|ref| (8 bf16 ulps of the largest logit), as the port's
    other bf16 LM checks;
  * the port's own forward against its decode: max|Δ|/max|ref| below 2e-2,
    4e-2 for the Griffin family — the reference's own gate
    (``tests/test_models_consistency.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
from torch_lm_checks import ref_init, strict_jit
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
B = 2

# The smoke configs of one dense, one MoE and the hybrid architecture; the
# hybrid's window is cut to 4 so that 12 tokens wrap its ring twice.
ARCHS = {"dense": ("qwen3-1.7b", {}), "moe": ("moonshot-v1-16b-a3b", {"capacity_factor": 2.0}),
         "griffin": ("recurrentgemma-9b", {"window": 4})}


def _np(t):
    return t.detach().float().numpy()


def _attn_cfgs(**kw):
    base = dict(d_model=32, n_heads=4, d_head=8, rope_theta=1e4, **kw)
    return jattn.AttentionConfig(**base), tattn.AttentionConfig(**base)


def _attn_params(jc, seed, bias):
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jc)
    if bias:
        rng = np.random.default_rng(seed)
        jp = {**jp, **{k: jnp.asarray(rng.normal(size=jp[k].shape).astype(np.float32))
                       for k in ("bq", "bk", "bv")}}
    flat = {}
    for k, v in jp.items():
        if isinstance(v, dict):
            flat[f"{k}.scale"] = torch.as_tensor(np.array(v["scale"]))
        else:
            flat[k] = torch.as_tensor(np.array(v))
    return jp, flat


@pytest.mark.parametrize("window,max_len,size", [(None, 12, 12), (4, 12, 4), (16, 12, 12)])
def test_init_kv_cache_shapes_and_dtypes(window, max_len, size):
    jc, tc = _attn_cfgs(n_kv_heads=2, window=window)
    want = jattn.init_kv_cache(jc, 3, max_len)
    got = tattn.init_kv_cache(tc, 3, max_len, CPU)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape == (3, size, 2, 8)
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16
        assert float(got[k].abs().max()) == 0.0


DECODE_CASES = {
    "gqa": dict(n_kv_heads=2),
    "mqa": dict(n_kv_heads=1),
    "qknorm-bias": dict(n_kv_heads=2, qk_norm=True, qkv_bias=True),
    "window4": dict(n_kv_heads=2, window=4),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_matches_reference(case):
    """Step by step over 11 tokens, caches carried by each side; with a
    window of 4 the ring wraps twice."""
    kw = DECODE_CASES[case]
    jc, tc = _attn_cfgs(**kw)
    jp, tp = _attn_params(jc, 3, kw.get("qkv_bias", False))
    steps = 11
    x = np.random.default_rng(4).normal(size=(B, steps, 32)).astype(np.float32)
    jcache = jattn.init_kv_cache(jc, B, steps)
    tcache = tattn.init_kv_cache(tc, B, steps, CPU)
    with jax.numpy_rank_promotion("allow"):
        step = jax.jit(lambda p, v, c, pos: jattn.decode_attention(p, jc, v, c, pos))
        for t in range(steps):
            jo, jcache = step(jp, jnp.asarray(x[:, t:t + 1]), jcache, jnp.int32(t))
            to, tcache = tattn.decode_attention(tp, tc, torch.as_tensor(x[:, t:t + 1]),
                                                tcache, t)
            np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL, err_msg=f"step {t}")
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[k]), np.asarray(jcache[k].astype(jnp.float32)),
                                   rtol=2.0**-8, atol=1e-6)


def test_decode_attention_writes_the_cache_in_place():
    _, tc = _attn_cfgs(n_kv_heads=2, window=4)
    _, tp = _attn_params(_attn_cfgs(n_kv_heads=2, window=4)[0], 5, False)
    cache = tattn.init_kv_cache(tc, B, 16, CPU)
    k = cache["k"]
    x = torch.randn(B, 1, 32, generator=torch.Generator().manual_seed(0))
    _, out = tattn.decode_attention(tp, tc, x, cache, 6)
    assert out["k"] is k and float(k[:, 6 % 4].abs().max()) > 0
    assert float(k[:, [0, 1, 3]].abs().max()) == 0.0


@pytest.mark.parametrize("path", ["dense", "blockwise"])
@pytest.mark.parametrize("window", [3, 5])
def test_windowed_attention_matches_reference(path, window):
    """T = 12: the dense path below 2·window, the blockwise one above it
    (chunks of 4 queries and 2 keys, some wholly older than the window)."""
    threshold = 4 if path == "blockwise" else 8192
    jc, tc = _attn_cfgs(n_kv_heads=2, window=window, blockwise_threshold=threshold,
                        chunk_q=4, chunk_kv=2)
    jp, tp = _attn_params(jc, 6, False)
    x = np.random.default_rng(7).normal(size=(B, 12, 32)).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (B, 1))
    want = np.asarray(jattn.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos)))
    got = _np(tattn.attention(tp, tc, torch.as_tensor(x), torch.as_tensor(pos)))
    np.testing.assert_allclose(got, want, **TOL)


def test_blockwise_window_equals_dense_window_in_the_port():
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 24, 4, 8)).astype(np.float32))
               for _ in range(3))
    cfg = tattn.AttentionConfig(d_model=32, n_heads=4, n_kv_heads=4, d_head=8, window=5,
                                chunk_q=8, chunk_kv=4)
    dense = tattn._dense_attention(q, k, v, 0.35, 0, 5)
    block = tattn._blockwise_attention(q, k, v, 0.35, cfg)
    np.testing.assert_allclose(_np(block), _np(dense), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# whole models: prefill, decode_step, serve state
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(name):
    """(reference config, port config, reference params, port params,
    jitted reference decode step) of one smoke model."""
    arch, kw = ARCHS[name]
    jcfg = dataclasses.replace(jregistry.smoke_config(arch), **kw)
    cfg = dataclasses.replace(smoke_config(arch), **kw)
    jp = ref_init(jcfg, 0)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    step = strict_jit(lambda p, s, b: jmodel.decode_step(p, jcfg, s, b))
    return jcfg, cfg, jp, tp, step


def _tokens(cfg, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _bf16_close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2.0**-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_step_and_prefill_match_reference(name):
    jcfg, cfg, jp, tp, step = _model(name)
    T = 12
    toks = _tokens(cfg, T, 1)
    js = jmodel.init_serve_state(jcfg, B, T)
    ts = tmodel.init_serve_state(cfg, B, T, CPU)
    with torch.inference_mode():
        for t in range(T):
            jl, js = step(jp, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
            tl, ts = tmodel.decode_step(tp, cfg, ts, {"tokens": torch.as_tensor(toks[:, t:t + 1])})
            assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, cfg.padded_vocab)
            _bf16_close(tl, jl, f"{name} step {t}")
        assert ts["pos"] == T == int(js["pos"])
        _, jlast = strict_jit(lambda p, b: jmodel.prefill(p, jcfg, b))(
            jp, {"tokens": jnp.asarray(toks)})
        hidden, tlast = tmodel.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)})
    assert tuple(hidden.shape) == (B, T, cfg.d_model) and tlast.dtype == torch.float32
    _bf16_close(tlast, jlast, f"{name} prefill")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serve_state_carries_over_from_the_reference(name):
    """Five steps in the reference, the state carried across, five more in
    the port beside five more in the reference."""
    jcfg, cfg, jp, tp, step = _model(name)
    T = 10
    toks = _tokens(cfg, T, 2)
    js = jmodel.init_serve_state(jcfg, B, T)
    for t in range(5):
        _, js = step(jp, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
    ts = convert.serve_state_from_reference(jax.tree.map(np.asarray, js), cfg, device="cpu")
    assert ts["pos"] == 5 and len(ts["layers"]) == cfg.n_layers
    fresh = tmodel.init_serve_state(cfg, B, T, CPU)
    for got, want in zip(ts["layers"], fresh["layers"]):
        assert {k: (v.dtype, v.shape) for k, v in got.items()} == {
            k: (v.dtype, v.shape) for k, v in want.items()}
    with torch.inference_mode():
        for t in range(5, T):
            jl, js = step(jp, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
            tl, ts = tmodel.decode_step(tp, cfg, ts, {"tokens": torch.as_tensor(toks[:, t:t + 1])})
            _bf16_close(tl, jl, f"{name} step {t}")


def test_serve_state_from_reference_refuses_a_mismatch():
    jcfg, cfg, _, _, _ = _model("griffin")
    js = jax.tree.map(np.asarray, jmodel.init_serve_state(jcfg, B, 4))
    with pytest.raises(ValueError, match="layers"):
        convert.serve_state_from_reference(js, dataclasses.replace(cfg, n_layers=4), "cpu")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_against_decode_in_the_port(name):
    """The reference's forward-against-decode gate on the port alone: each
    step's logits against forward's bf16 hidden @ unembed."""
    _, cfg, _, tp, _ = _model(name)
    T = 12
    toks = torch.as_tensor(_tokens(cfg, T, 3))
    tol = 4e-2 if cfg.family == "hybrid" else 2e-2
    with torch.inference_mode():
        hidden, _ = tmodel.forward(tp, cfg, {"tokens": toks})
        ref = (hidden.to(tmodel.COMPUTE_DTYPE)
               @ tmodel.unembed_matrix(tp).to(tmodel.COMPUTE_DTYPE).T).float()
        state = tmodel.init_serve_state(cfg, B, T, CPU)
        outs = []
        for t in range(T):
            logits, state = tmodel.decode_step(tp, cfg, state, {"tokens": toks[:, t:t + 1]})
            outs.append(logits)
    err = float((ref - torch.stack(outs, 1)).abs().max()) / float(ref.abs().max())
    assert err < tol, f"{name}: rel err {err:.3e}"
    assert state["pos"] == T


def test_prefill_and_decode_refuse_unported_kinds():
    """xLSTM layers now build their decode states ({C, n, m, conv} for
    'mlstm', {c, n, h, m} for 'slstm', as the reference's); a layer kind
    the reference has no mixer for is still refused."""
    cfg = ModelConfig(name="x", family="ssm", n_layers=2, d_model=16, n_heads=2,
                      n_kv_heads=2, d_ff=0, vocab_size=32, block_pattern=("mlstm", "slstm"))
    state = tmodel.init_serve_state(cfg, 1, 4, CPU)
    assert sorted(state["layers"][0]) == ["C", "conv", "m", "n"]
    assert sorted(state["layers"][1]) == ["c", "h", "m", "n"]
    assert tuple(state["layers"][0]["C"].shape) == (1, 2, 8, 8) and state["pos"] == 0
    with pytest.raises(ValueError, match="layer kinds"):
        tmodel.init_serve_state(dataclasses.replace(cfg, block_pattern=("mamba",)), 1, 4, CPU)


# Full-depth stacks at smoke width: recurrentgemma-9b's whole 38-layer
# pattern, a 40-layer dense stack, xlstm-1.3b's 48 layers (six (7 ×
# mlstm, slstm) periods) and musicgen-medium's 48 layers with its four
# codebook heads.  Each: (arch, overrides, steps, the bound the card holds
# it to in chip_smoke.py phase 12, step 0's bound, the reference's gate at
# its own depth and the comparison that lies past it here or None).  The
# card's bounds: 4e-2·√(38/5) past the reference's 5-layer recurrent gate,
# the reference's 2e-2 for a dense stack, and for xlstm-1.3b and
# musicgen-medium 1.25 × the card's reading (chip_smoke.SERVE_EMB_CELLS).
# Step 0 is the reference's to 2e-8 for the token-input dense and Griffin
# stacks, and to fp32 rounding (1e-5) for the xLSTM stack, whose gates run
# fp32 exp and log, and for the codebook stack (1.4e-7 read).
XLSTM_CARD_BOUND = 1.25 * 0.2099  # chip_smoke.py: SERVE_MARGIN × the H100's reading
MUSICGEN_CARD_BOUND = 1.25 * 2.099e-2
DEPTH = {"griffin": ("recurrentgemma-9b", {"n_layers": 38, "window": 4}, 12,
                     4e-2 * (38 / 5) ** 0.5, 2e-8,
                     (4e-2, "reference forward against its decode")),
         "dense": ("qwen3-1.7b", {"n_layers": 40}, 12, 2e-2, 2e-8, None),
         "xlstm": ("xlstm-1.3b", {"n_layers": 48}, 24, XLSTM_CARD_BOUND, 1e-5,
                   (4e-2, "reference forward against its decode")),
         "codebooks": ("musicgen-medium", {"n_layers": 48}, 24, MUSICGEN_CARD_BOUND, 1e-5,
                       (2e-2, "port against reference decode"))}


@pytest.mark.parametrize("name", sorted(DEPTH))
def test_decode_at_depth_is_the_references(name):
    """The port's decode held to the strictly compiled reference's decode
    at full depth, not to the port's forward.

    The first step's logits are the reference's to rounding: every layer
    computes what the reference's does.  Later steps part at the first
    bf16 rounding that the CPU libraries' summation orders flip (the
    dense stack: one of layer 10's 64 v-projection values at step 6); from
    there the two decodes differ by about as much as either package's own
    forward differs from its decode.  So the growth with depth is the
    reference's: both packages' decodes, and each package's forward
    against its decode, lie within the bound the card holds at this depth;
    the reference's own Griffin and xLSTM decodes lie past their shallow
    gates (5 and 4 layers), and at musicgen-medium's depth two faithful
    decodes, the port's and the reference's, part by more than the
    reference's 2-layer gate (on the CPU each package's forward equals its
    own decode there)."""
    arch, kw, T, bound, step0, past = DEPTH[name]
    jcfg = dataclasses.replace(jregistry.smoke_config(arch), **kw)
    cfg = dataclasses.replace(smoke_config(arch), **kw)
    jp = ref_init(jcfg, 0)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    step = strict_jit(lambda p, s, b: jmodel.decode_step(p, jcfg, s, b))
    key = "tokens" if cfg.frontend == "tokens" else "embeddings"
    if key == "tokens":
        x = _tokens(cfg, T, 1)
    else:
        x = np.random.default_rng(1).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    js = jmodel.init_serve_state(jcfg, B, T)
    ts = tmodel.init_serve_state(cfg, B, T, CPU)
    jo, to = [], []
    with torch.inference_mode():
        for t in range(T):
            jl, js = step(jp, js, {key: jnp.asarray(x[:, t:t + 1])})
            tl, ts = tmodel.decode_step(tp, cfg, ts, {key: torch.as_tensor(x[:, t:t + 1])})
            jo.append(np.asarray(jl))
            to.append(_np(tl))
        hidden, _ = tmodel.forward(tp, cfg, {key: torch.as_tensor(x)})
        w = tmodel.unembed_matrix(tp).to(tmodel.COMPUTE_DTYPE)  # (V, D) or (C, V, D)
        tfwd = _np(torch.einsum("btd,cvd->btcv", hidden, w) if w.dim() == 3 else hidden @ w.T)
    jh, _ = strict_jit(lambda p, b: jmodel.forward(p, jcfg, b))(jp, {key: jnp.asarray(x)})
    un = jp["unembed"].astype(jh.dtype)  # (D, V) or (C, D, V)
    jfwd = np.asarray((jnp.einsum("btd,cdv->btcv", jh, un) if un.ndim == 3 else jh @ un)
                      .astype(jnp.float32))
    jo, to = np.stack(jo, 1), np.stack(to, 1)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert rel(to[:, 0], jo[:, 0]) <= step0, f"{name}: step 0 {rel(to[:, 0], jo[:, 0]):.3e}"
    errs = {"port against reference decode": rel(to, jo),
            "reference forward against its decode": rel(jo, jfwd),
            "port forward against its decode": rel(to, tfwd)}
    assert all(e < bound for e in errs.values()), f"{name}: {errs} (bound {bound:.3f})"
    if past is not None:
        gate, which = past
        assert errs[which] > gate, (name, errs)
