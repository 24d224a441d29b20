"""The port's xLSTM family (mLSTM and sLSTM cells, ``repro_torch.models.
recurrent``; the xlstm-1.3b config) against the JAX reference on the CPU.

Cells: the reference's ``init_mlstm``/``init_slstm`` weights carried
across as they are (``wq``/``wk``/``wv`` (di, H, d), ``r_in`` (4, H, d,
d), ``out_norm`` flattened to ``out_norm.scale``), fp32 inputs, held to
1e-5 relative (rtol 1e-5, atol 1e-5·max|ref|): the same algorithm, the
products and ``cumsum`` in another summation order.  The mLSTM chunk
sizes reassociate exactly, so chunks 4, 8 and T agree with one another to
the reference's own tolerance (``tests/test_recurrent.py``: rtol 2e-4,
atol 2e-5).  Whole models (the reference's consistency config ``xlstm``
and the xlstm-1.3b smoke config) go through ``torch_lm_checks``, whose
docstring states those tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.configs import registry as jregistry
from repro.models import recurrent as jrec
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as trec
from repro_torch.models.config import ModelConfig
import torch_lm_checks as checks
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

D, H, HD = 16, 2, 8
CPU = torch.device("cpu")
# tests/test_models_consistency.py's 'xlstm' config
CONSISTENCY = dict(name="xlstm", family="ssm", n_layers=4, d_model=64, n_heads=4,
                   n_kv_heads=4, d_ff=0, vocab_size=128,
                   block_pattern=("mlstm", "mlstm", "mlstm", "slstm"), mlstm_chunk=8)


def _flat(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = torch.as_tensor(np.array(v))
    return out


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _mlstm(chunk=8, seed=0):
    jc = jrec.MLSTMConfig(d_model=D, n_heads=H, d_head=HD, chunk=chunk)
    tc = trec.MLSTMConfig(d_model=D, n_heads=H, d_head=HD, chunk=chunk)
    jp = jrec.init_mlstm(jax.random.PRNGKey(seed), jc)
    # non-trivial gate bias, skip and norm scales, so each enters the check
    rng = np.random.default_rng(seed)
    jp = {**jp, "b_if": jnp.asarray(rng.normal(size=2 * H).astype(np.float32)),
          "skip_scale": jnp.asarray(rng.uniform(0.5, 1.5, H * HD).astype(np.float32)),
          "out_norm": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, H * HD).astype(np.float32))}}
    return jc, tc, jp, _flat(jp)


def _slstm(seed=0):
    jc = jrec.SLSTMConfig(d_model=D, n_heads=H, d_head=HD)
    tc = trec.SLSTMConfig(d_model=D, n_heads=H, d_head=HD)
    jp = jrec.init_slstm(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, _flat(jp)


def test_init_matches_the_reference_shapes_and_scales():
    di = H * HD
    for jinit, tinit, jc, tc in (
        (jrec.init_mlstm, trec.init_mlstm, jrec.MLSTMConfig(D, H, HD), trec.MLSTMConfig(D, H, HD)),
        (jrec.init_slstm, trec.init_slstm, jrec.SLSTMConfig(D, H, HD), trec.SLSTMConfig(D, H, HD)),
    ):
        want = _flat(jinit(jax.random.PRNGKey(0), jc))
        got = tinit(tc, torch.Generator().manual_seed(0), CPU)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        for k in got:
            if k in ("b_if", "b", "skip_scale", "out_norm.scale"):  # constants
                assert torch.equal(got[k], want[k]), k
            else:  # draws truncated at 2/√fan_in, ×0.1 for conv, ×0.5 for r_in
                scale = {"conv": 0.1, "r_in": 0.5}.get(k, 1.0)
                assert float(got[k].abs().max()) <= scale * 2.0 / np.sqrt(got[k].shape[0]), k
                assert float(got[k].std()) > scale * 0.5 / np.sqrt(got[k].shape[0]), k
    m = trec.init_mlstm(trec.MLSTMConfig(D, H, HD), torch.Generator().manual_seed(0), CPU)
    assert m["b_if"].tolist() == [0.0] * H + [3.0] * H
    s = trec.init_slstm(trec.SLSTMConfig(D, H, HD), torch.Generator().manual_seed(0), CPU)
    assert s["b"].tolist() == [0.0] * di + [3.0] * di + [0.0] * 2 * di


@pytest.mark.parametrize("T", [5, 16])
def test_mlstm_matches_reference(T):
    jc, tc, jp, tp = _mlstm(chunk=8, seed=1)
    x = _x((2, T, D), T)
    want = jax.jit(lambda p, v: jrec.mlstm(p, jc, v))(jp, jnp.asarray(x))
    _rel(trec.mlstm(tp, tc, torch.as_tensor(x)).numpy(), want)


def test_mlstm_chunk_size_invariance_and_reference():
    """Chunks 4, 8 and T = 24 in the port, each held to the reference's
    output at the same chunk, and to one another."""
    x = _x((2, 24, D), 2)
    outs = []
    for chunk in (4, 8, 24):
        jc, tc, jp, tp = _mlstm(chunk=chunk, seed=0)
        want = jax.jit(lambda p, v: jrec.mlstm(p, jc, v))(jp, jnp.asarray(x))
        got = trec.mlstm(tp, tc, torch.as_tensor(x)).numpy()
        _rel(got, want)
        outs.append(got)
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-5)


def test_mlstm_decode_matches_reference_step_by_step():
    jc, tc, jp, tp = _mlstm(seed=3)
    x = _x((2, 10, D), 4)
    step = jax.jit(lambda p, v, s: jrec.mlstm_decode(p, jc, v, s))
    js = jrec.init_mlstm_state(jc, 2)
    ts = trec.init_mlstm_state(tc, 2, CPU)
    assert {k: (tuple(v.shape), v.dtype) for k, v in ts.items()} == {
        k: (v.shape, torch.float32) for k, v in js.items()}
    for t in range(10):
        jo, js = step(jp, jnp.asarray(x[:, t:t + 1]), js)
        to, ts = trec.mlstm_decode(tp, tc, torch.as_tensor(x[:, t:t + 1]), ts)
        _rel(to.numpy(), jo)
    for k in ("C", "n", "m", "conv"):
        _rel(ts[k].numpy(), js[k])


@pytest.mark.parametrize("T", [1, 9])
def test_slstm_matches_reference(T):
    jc, tc, jp, tp = _slstm(seed=5)
    x = _x((2, T, D), 6)
    want = jax.jit(lambda p, v: jrec.slstm(p, jc, v))(jp, jnp.asarray(x))
    _rel(trec.slstm(tp, tc, torch.as_tensor(x)).numpy(), want)


def test_slstm_decode_matches_reference_step_by_step():
    jc, tc, jp, tp = _slstm(seed=7)
    x = _x((2, 8, D), 8)
    step = jax.jit(lambda p, v, s: jrec.slstm_decode(p, jc, v, s))
    js = jrec.init_slstm_state(jc, 2)
    ts = trec.init_slstm_state(tc, 2, CPU)
    for t in range(8):
        jo, js = step(jp, jnp.asarray(x[:, t:t + 1]), js)
        to, ts = trec.slstm_decode(tp, tc, torch.as_tensor(x[:, t:t + 1]), ts)
        _rel(to.numpy(), jo)
    for name, want in zip(("c", "n", "h", "m"), js):  # the reference's tuple order
        _rel(ts[name].numpy(), want)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _cfgs(which):
    if which == "consistency":
        return JModelConfig(**CONSISTENCY), ModelConfig(**CONSISTENCY)
    return jregistry.smoke_config("xlstm-1.3b"), smoke_config("xlstm-1.3b")


def test_config_is_the_reference():
    full = get_config("xlstm-1.3b")
    assert dataclasses.asdict(full) == dataclasses.asdict(jregistry.get_config("xlstm-1.3b"))
    assert full.param_count() == 1_414_891_520  # 5.7 GB in fp32
    small = smoke_config("xlstm-1.3b")
    assert dataclasses.asdict(small) == dataclasses.asdict(jregistry.smoke_config("xlstm-1.3b"))
    assert small.head_dim == small.d_model // small.n_heads == 16
    assert small.layer_kinds == ("mlstm",) * 7 + ("slstm", "mlstm", "mlstm")


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("which", ["consistency", "smoke"])
def test_training_entry_points_match_reference(which, mode, monkeypatch):
    if mode == "fp32":
        monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg = _cfgs(which)
    jp, tp = checks.pair(jcfg, cfg)
    assert "embed" in tp and not any(k.startswith("layers.0.ffn") for k in tp)
    checks.check_training_entry_points(jcfg, cfg, jp, tp, checks.make_batch(cfg, 1), mode)


@pytest.mark.parametrize("which", ["consistency", "smoke"])
def test_prefill_and_decode_match_reference(which):
    jcfg, cfg = _cfgs(which)
    jp, tp = checks.pair(jcfg, cfg, seed=1)
    checks.check_serving_entry_points(jcfg, cfg, jp, tp, checks.make_batch(cfg, 2))


def test_serve_state_round_trip_and_refusal():
    """A reference xLSTM serve state (mLSTM dicts, sLSTM tuples) carried
    across, then decoded further beside the reference; a state of another
    depth is refused."""
    jcfg, cfg = _cfgs("consistency")
    jp, tp = checks.pair(jcfg, cfg, seed=2)
    toks = checks.make_batch(cfg, 3)["tokens"]
    step = checks.strict_jit(lambda p, s, b: jmodel.decode_step(p, jcfg, s, b))
    js = jmodel.init_serve_state(jcfg, checks.B, checks.T)
    for t in range(4):
        _, js = step(jp, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
    ts = convert.serve_state_from_reference(jax.tree.map(np.asarray, js), cfg, device="cpu")
    assert ts["pos"] == 4 and sorted(ts["layers"][3]) == ["c", "h", "m", "n"]
    with torch.inference_mode():
        for t in range(4, 8):
            jl, js = step(jp, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
            tl, ts = tmodel.decode_step(tp, cfg, ts, {"tokens": torch.as_tensor(toks[:, t:t + 1])})
            checks.close(tl.numpy(), jl, "bf16", f"step {t}")
    with pytest.raises(ValueError, match="layers"):
        convert.serve_state_from_reference(jax.tree.map(np.asarray, js),
                                           dataclasses.replace(cfg, n_layers=8), "cpu")
