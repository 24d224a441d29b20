"""Train and select step factories.

Port of ``repro.train.train_step``:

* ``make_train_step`` — γ-weighted loss → gradients (autograd) →
  optimizer update, with optional micro-batch accumulation (the batch is
  split along dim 0, gradients summed and divided by the count);
* ``make_select_step`` — the CRAIG selection forward: pooled proxy
  features (B, D) for a pool batch.

Batches are dicts in the reference's ``train_batch_struct`` layout
(``models/model.py``): ``tokens`` or ``embeddings`` (B, T, D),
``labels`` (B, T) or (B, T, n_codebooks), optional ``positions`` (B, T)
or (B, 3, T) and ``weights`` (B,); micro-batches split every entry along
dim 0.

Gradient compression on a data-parallel axis (``grad_transform``) comes
with model parallelism and multi-GPU meshes (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import loss_fn as model_loss_fn
from repro_torch.models import proxy_features, proxy_features_fused
from repro_torch.models import loops
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer, OptState

__all__ = ["make_train_step", "make_select_step", "PROXY_IMPLS"]

PROXY_IMPLS = ("auto", "einsum", "cuda", "torch")


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, microbatches: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics); params and state are updated in place (see optimizers.py)."""

    def grads_of(params, batch):
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        total, metrics = model_loss_fn(dict(zip(names, leaves)), cfg, batch)
        grads = torch.autograd.grad(total, leaves)
        return total.detach(), metrics, dict(zip(names, grads))

    def accumulated(params, batch):
        split = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
        grads, loss_sum, metrics = None, 0.0, None
        for i in loops.steps(microbatches):
            loss, metrics, g = grads_of(params, {k: v[i] for k, v in split.items()})
            loss_sum = loss_sum + loss
            if grads is None:
                grads = {k: t.float() for k, t in g.items()}
            else:
                for k, t in g.items():
                    grads[k].add_(t)
        for t in grads.values():
            t.div_(microbatches)
        return loss_sum / microbatches, metrics, grads

    def train_step(params, opt_state: OptState, batch):
        if microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not divisible into {microbatches} microbatches")
            loss, metrics, grads = accumulated(params, batch)
        else:
            loss, metrics, grads = grads_of(params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {
            "loss": loss,
            "aux_loss": metrics["aux_loss"].detach(),
            "step": opt_state.step,
        }

    return train_step


def make_select_step(
    cfg: ModelConfig, proxy_impl: str = "auto", compute_dtype: torch.dtype | None = None
) -> Callable:
    """select_step(params, batch) → (B, D) fp32 proxy features.

    ``proxy_impl`` picks the CE-backward head:

    * ``'auto'`` (default): the fused ``ce_proxy`` CUDA kernel when the
      parameters are on a card (as the reference takes its kernel on its
      accelerator), the chunked einsum path on the CPU;
    * ``'einsum'``: ``core.proxy.lm_unembed_input_proxy``;
    * ``'cuda'``: the fused kernel (raises off the card);
    * ``'torch'``: the fused flattening with ``ce_proxy``'s plain twin.

    ``compute_dtype`` overrides the fused head's matmul dtype (None keeps
    the model's bf16).
    """
    if proxy_impl not in PROXY_IMPLS:
        raise ValueError(f"unknown proxy_impl {proxy_impl!r} (want one of {PROXY_IMPLS})")
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}

    def select_step(params, batch):
        impl = proxy_impl
        if impl == "auto":
            impl = "cuda" if params["final_norm.scale"].device.type == "cuda" else "einsum"
        if impl == "einsum":
            return proxy_features(params, cfg, batch)
        return proxy_features_fused(params, cfg, batch, impl=impl, **kw)

    return select_step
