"""Optimizers, the train step, and the data pipeline of the port against the
JAX reference on the CPU.

Tolerances:
  * one optimizer update on the same params and grads: rtol 1e-6,
    atol 1e-7 — the same fp32 formulas, fused differently;
  * schedules: rtol 1e-6 plus atol 4·ε₃₂·lr0 (the reference evaluates
    them in fp32, the port in fp64; near the end of the cosine 1 + cos
    cancels and leaves the reference's fp32 rounding of lr0-sized terms);
  * train-step losses over a few AdamW steps, fp32 compute: rtol 1e-4 —
    AdamW's m/√v normalises every coordinate, so gradient coordinates near
    zero that round differently move by up to lr per step and the two
    trajectories drift apart slowly; bf16 compute: rtol 1e-2 (bf16 logits);
  * data: exact (the same numpy generators).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.data import pipeline as jpipe
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import optimizers as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as topt
from repro_torch.train.train_step import make_train_step
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

SMALL = dict(
    name="tiny-qwen3", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab_size=250, qk_norm=True,
    rope_theta=1e6, logit_chunk=8,
)


def _t(a):
    return torch.as_tensor(np.array(a))


def _tree(rng):
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw", "adamw_wd"])
def test_optimizer_updates_match_reference(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    sched_j, sched_t = jopt.k_inverse(0.05, 0.5), topt.k_inverse(0.05, 0.5)
    make = {
        "sgd": (lambda s: jopt.sgd(s, clip=0.5), lambda s: topt.sgd(s, clip=0.5)),
        "momentum": (lambda s: jopt.momentum(s), lambda s: topt.momentum(s)),
        "adamw": (lambda s: jopt.adamw(s), lambda s: topt.adamw(s)),
        "adamw_wd": (lambda s: jopt.adamw(s, weight_decay=0.1, clip=None),
                     lambda s: topt.adamw(s, weight_decay=0.1, clip=None)),
    }[name]
    jo, to = make[0](sched_j), make[1](sched_t)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        grads = {k: (rng.normal(size=v.shape) * (3.0 if step == 0 else 0.3)).astype(np.float32)
                 for k, v in params.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        tp, ts = to.update({k: _t(v) for k, v in grads.items()}, ts, tp)
        assert ts.step == int(js.step) == step + 1
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_schedules_and_clipping_match_reference():
    for j, t in ((jopt.warmup_cosine(3e-4, 5, 20), topt.warmup_cosine(3e-4, 5, 20)),
                 (jopt.exponential_decay(0.1, 0.9), topt.exponential_decay(0.1, 0.9)),
                 (jopt.k_inverse(0.1, 0.2, 0.7), topt.k_inverse(0.1, 0.2, 0.7)),
                 (jopt.constant(0.01), topt.constant(0.01))):
        for step in (0, 1, 4, 5, 6, 19, 20, 30):
            np.testing.assert_allclose(t(step), float(j(jnp.asarray(step, jnp.int32))),
                                       rtol=1e-6, atol=4 * 2.0**-23 * 0.1)
    g = _tree(np.random.default_rng(1))
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    tc, tn = topt.clip_by_global_norm({k: _t(v) for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 250, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 250, (4, 16)).astype(np.int32),
             "weights": rng.uniform(0.5, 2.0, 4).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_give_the_reference_losses(mode, microbatches, monkeypatch):
    if mode == "fp32":
        monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg = JModelConfig(**SMALL), ModelConfig(**SMALL)
    jp = ref_init(jcfg, 0)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    sched = (jopt.warmup_cosine(2e-3, 2, 6), topt.warmup_cosine(2e-3, 2, 6))
    jstep = jax.jit(jmake_train_step(jcfg, jopt.adamw(sched[0]), microbatches=microbatches))
    tstep = make_train_step(cfg, topt.adamw(sched[1]), microbatches=microbatches)
    jo, to = jopt.adamw(sched[0]).init(jp), topt.adamw(sched[1]).init(tp)
    jl, tl = [], []
    for b in _batches(4):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: _t(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert tm["step"] == int(jm["step"])
    np.testing.assert_allclose(tl, jl, rtol=1e-4 if mode == "fp32" else 1e-2)


def test_microbatch_accumulation_equals_one_batch(monkeypatch):
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)  # bf16 rounds per batch shape
    cfg = ModelConfig(**SMALL)
    b = {k: _t(v) for k, v in _batches(1, seed=3)[0].items()}
    b["weights"] = torch.ones(4)  # equal weights: the mean of halves is the whole
    out = {}
    for mb in (1, 2):
        tp = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
        step = make_train_step(cfg, topt.sgd(topt.constant(0.1)), microbatches=mb)
        tp, _, m = step(tp, topt.sgd(topt.constant(0.1)).init(tp), b)
        out[mb] = (float(m["loss"]), tp)
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-5)
    for k in out[1][1]:  # fp32 sums in another order
        np.testing.assert_allclose(out[2][1][k].numpy(), out[1][1][k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


# -- data ----------------------------------------------------------------------


def test_token_stream_matches_reference():
    j = JTokenStream(n_docs=40, seq_len=24, vocab_size=1000, n_topics=6, seed=3)
    t = TokenStream(n_docs=40, seq_len=24, vocab_size=1000, n_topics=6, seed=3)
    idx = np.array([0, 7, 39, 7, 12])
    jb, tb = j.batch(idx), t.batch(idx)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tb[k], jb[k])
        assert tb[k].dtype == jb[k].dtype == np.int32
    np.testing.assert_array_equal(t.class_labels(idx), j.class_labels(idx))


def _drive(sampler, steps):
    return [tuple(map(np.asarray, sampler.next_batch())) for _ in range(steps)]


def test_coreset_sampler_matches_reference_index_for_index():
    js, ts = jpipe.CoresetSampler(30, 4, seed=5), tpipe.CoresetSampler(30, 4, seed=5)
    seq = [(_drive(js, 9), _drive(ts, 9))]
    idx = np.array([3, 17, 4, 29, 11, 0, 8])
    w = np.array([5.0, 1.0, 2.0, 7.0, 3.0, 4.0, 8.0], np.float32)
    for s in (js, ts):
        s.stage(idx, w, version=1, meta={"engine": {"name": "matrix"}})
        assert s.has_pending and s.pending_version == 1
        s.install_pending()
    seq.append((_drive(js, 5), _drive(ts, 5)))
    for s in (js, ts):
        s.stage(idx[:5], w[:5], version=2)
    state_j, state_t = js.state_dict(), ts.state_dict()
    assert state_t == state_j
    js2, ts2 = jpipe.CoresetSampler(30, 4, seed=5), tpipe.CoresetSampler(30, 4, seed=5)
    js2.load_state_dict(state_j)
    ts2.load_state_dict(state_t)
    for s in (js2, ts2):
        s.install_pending()
    seq.append((_drive(js2, 6), _drive(ts2, 6)))
    for ref, got in seq:
        for (ri, rw), (gi, gw) in zip(ref, got):
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gw, rw)
    assert ts2.version == js2.version == 2


def test_global_batcher_and_prefetcher():
    ds = TokenStream(n_docs=20, seq_len=8, vocab_size=50)
    jb = jpipe.GlobalBatcher(JTokenStream(n_docs=20, seq_len=8, vocab_size=50),
                             jpipe.CoresetSampler(20, 3, seed=1))
    tb = tpipe.GlobalBatcher(ds, tpipe.CoresetSampler(20, 3, seed=1))
    pf = tpipe.Prefetcher(iter(tb), depth=2)
    try:
        for _ in range(8):
            want, got = jb.next(), pf.next()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        pf.close()
    dev = tpipe.to_device(got, torch.device("cpu"))
    assert dev["tokens"].dtype == torch.int64 and dev["weights"].dtype == torch.float32

    def boom():
        yield 1
        raise KeyError("bad index")

    pf = tpipe.Prefetcher(boom())
    assert pf.next() == 1
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        pf.next()
    pf.close()
