"""The reference's leftovers the port now reads: ``data.synthetic.GaussianMixture``
and the reference's ``.npy``-directory checkpoints.

A reference checkpoint (``manifest.json`` + ``arrays/<id>.npy``) of an LM's
parameters and AdamW state, written by the reference's own
``CheckpointManager`` after two steps, is read back by the port's
``CheckpointManager.restore_reference`` (numpy alone) and converted
(``convert.model_params_from_reference``, ``convert.opt_state_from_reference``);
with fp32 products, the next two steps' losses are the reference's within
``test_torch_lm_train.py``'s tolerance for them (rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.model as jmodel
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.synthetic import GaussianMixture as JGaussianMixture
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import optimizers as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import GaussianMixture
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as topt
from repro_torch.train.train_step import make_train_step
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

SMALL = dict(
    name="tiny-qwen3", family="dense", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab_size=250, qk_norm=True,
    rope_theta=1e6, logit_chunk=8, block_pattern=("attn", "attn"),
)


def test_gaussian_mixture_matches_reference():
    j, t = JGaussianMixture(300, 7, 3, seed=4), GaussianMixture(300, 7, 3, seed=4)
    np.testing.assert_array_equal(t.x, j.x)
    np.testing.assert_array_equal(t.y, j.y)
    idx = np.array([5, 0, 299, 5])
    for a, b in zip(t.subset(idx), j.subset(idx)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.class_labels(idx), j.class_labels(idx))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 250, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 250, (4, 16)).astype(np.int32),
             "weights": rng.uniform(0.5, 2.0, 4).astype(np.float32)} for _ in range(n)]


def test_reference_checkpoint_restores_and_trains_on(monkeypatch, tmp_path):
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg = JModelConfig(**SMALL), ModelConfig(**SMALL)  # one period + one remainder
    jopt_, topt_ = jopt.adamw(jopt.warmup_cosine(2e-3, 2, 6)), topt.adamw(
        topt.warmup_cosine(2e-3, 2, 6))
    jstep = jax.jit(jmake_train_step(jcfg, jopt_))
    jp = ref_init(jcfg, 0)
    jo = jopt_.init(jp)
    batches = _batches(4)
    for b in batches[:2]:
        jp, jo, _ = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
    JCheckpointManager(str(tmp_path)).save(2, {"params": jp, "opt": jo}, {"cursor": 8})

    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_step() == 2
    tree, extras = ckpt.restore_reference()
    assert extras == {"cursor": 8}
    tp = convert.model_params_from_reference(tree["params"], cfg, device="cpu")
    to = convert.opt_state_from_reference(tree["opt"], cfg, device="cpu")
    assert to.step == 2 and sorted(to.inner) == ["m", "v"]
    want = convert.model_params_from_reference(jax.tree.map(np.asarray, jo.inner["m"]), cfg,
                                               device="cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(to.inner["m"][k].numpy(), v.numpy(), err_msg=k)

    # the next step's loss reads the restored parameters, the one after
    # also the update the restored AdamW moments made
    tstep = make_train_step(cfg, topt_)
    for b in batches[2:]:
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: torch.as_tensor(v) for k, v in b.items()})
        assert to.step == int(jo.step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
