"""Remat policies of the port's layer stack (``repro_torch.models.blocks``)
on the CPU: ``"dots"`` against ``"nothing"`` and ``"full"``.

The reference's check (``tests/test_model_details.py``, remat value
invariance) holds each policy's loss and gradients to ``"nothing"``'s;
here the three policies run the same ops on the same inputs, so the loss
and the gradients are equal bit for bit.  What a policy keeps for the
backward is counted over the forward: the tensors autograd packs through
``torch.autograd.graph.saved_tensors_hooks`` (outside a checkpointed
layer; inside one the checkpoint's own hook takes them) plus the matrix
products the ``"dots"`` policy keeps (``blocks.save_dots`` returning
MUST_SAVE; its cache is not a saved tensor).  ``"full"`` keeps every
layer's intermediates, ``"nothing"`` none of them, ``"dots"`` each layer's
``x @ W`` outputs: strictly between.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.models import blocks
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

CFGS = {
    "dense": ModelConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
                         n_kv_heads=2, d_ff=64, vocab_size=128, logit_chunk=8, qk_norm=True),
    "xlstm": ModelConfig(name="x", family="ssm", n_layers=2, d_model=32, n_heads=2,
                         n_kv_heads=2, d_ff=0, vocab_size=128, logit_chunk=8,
                         block_pattern=("mlstm", "slstm"), mlstm_chunk=4),
    "moe": ModelConfig(name="m", family="moe", n_layers=2, d_model=32, n_heads=2,
                       n_kv_heads=1, d_ff=32, vocab_size=128, logit_chunk=8, n_experts=4,
                       top_k=2, capacity_factor=2.0),
}
POLICIES = ("nothing", "dots", "full")


def _batch(cfg, B=2, T=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=g),
            "labels": torch.randint(0, cfg.vocab_size, (B, T), generator=g),
            "weights": torch.rand(B, generator=g) + 0.5}


def _run(cfg, policy, params, batch, monkeypatch):
    """Loss, gradients and the count of tensors kept for the backward."""
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    kept = {"hooks": 0, "dots": 0}

    def pack(t):
        kept["hooks"] += 1
        return t

    def counted(ctx, op, *args, **kwargs):
        out = save_dots(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept["dots"] += 1
        return out

    save_dots = blocks.save_dots
    monkeypatch.setattr(blocks, "save_dots", counted)
    names = list(params)
    leaves = [params[k].detach().clone().requires_grad_(True) for k in names]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = tmodel.loss_fn(dict(zip(names, leaves)), cfg, batch)
    n_kept = sum(kept.values())
    grads = torch.autograd.grad(total, leaves)
    monkeypatch.setattr(blocks, "save_dots", save_dots)
    return float(total.detach()), dict(zip(names, grads)), n_kept, kept["dots"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_dots_gradients_equal_nothing_and_full(name, dtype, monkeypatch):
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", getattr(torch, dtype))
    cfg = CFGS[name]
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    runs = {p: _run(cfg, p, params, batch, monkeypatch) for p in POLICIES}
    loss, grads, _, _ = runs["dots"]
    assert np.isfinite(loss)
    for other in ("nothing", "full"):
        assert runs[other][0] == loss, (other, runs[other][0], loss)
        for k, g in grads.items():
            assert torch.equal(runs[other][1][k], g), f"{name} {dtype}: {k} against {other}"


@pytest.mark.parametrize("name", sorted(CFGS))
def test_dots_keeps_strictly_between_nothing_and_full(name, monkeypatch):
    cfg = CFGS[name]
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    kept = {p: _run(cfg, p, params, batch, monkeypatch)[2:] for p in POLICIES}
    assert kept["nothing"][0] < kept["dots"][0] < kept["full"][0], kept
    assert kept["dots"][1] > 0 and kept["nothing"][1] == kept["full"][1] == 0, kept


def test_dots_saves_plain_products_and_recomputes_batched_ones():
    """The policy keeps ``aten.mm``/``aten.addmm`` (``x @ W``, no batch
    dimension) and recomputes ``aten.bmm`` (attention scores) and the rest,
    as ``checkpoint_dots_with_no_batch_dims`` does."""
    aten = torch.ops.aten
    must, prefer = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    assert blocks.save_dots(None, aten.mm.default) == must
    assert blocks.save_dots(None, aten.addmm.default) == must
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default, aten.cat.default):
        assert blocks.save_dots(None, op) == prefer
