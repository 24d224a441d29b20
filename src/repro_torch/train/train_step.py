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

On a mesh the parameters are DTensors (``distributed/sharding.py``'s
``param_specs``, or ``serve_param_specs`` for serving) and the batch is
placed by ``batch_specs``; both steps then run on them as they are.
Plain tensors the models make (positions, masks, RoPE tables) meet the
DTensors as replicated ones (``implicit_replication``), the models' own
``constrain`` calls pin the activations (``distributed/annotate.py``; the
step sets the parameters' mesh there when none is set), and each
gradient is redistributed to its parameter's placements — the
reduce-scatter of ZeRO — before the optimizer updates the shards.
Micro-batches of a placed batch are its row blocks, as without a mesh:
the batch is gathered once and each block placed as the batch was.

``grad_transform`` is the reference's hook for gradient compression
(``distributed.compression.compressed_psum``), which runs inside
``shard_map`` on each replica's own gradient, so that its wire replaces
the reduction over the replicas.  On a mesh the step gives it the same:
the parameters are gathered over the data-parallel dims (``pod``,
``data``) before the loss, so autograd leaves the gradients unreduced
there, and the hook gets each as a DTensor with ``Partial("avg")`` on
those dims — its local tensor is this replica's gradient, and the
gradient is the replicas' mean.  The hook returns them reduced (any
placement), and the step places them as above.  The gathered parameters
cost the ZeRO-3 saving of parameter memory for the step; the optimizer
state stays split.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable

import torch

from repro_torch import spans
from repro_torch.distributed import annotate
from repro_torch.models import loss_fn as model_loss_fn
from repro_torch.models import proxy_features, proxy_features_fused
from repro_torch.models import loops
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer, OptState

__all__ = ["make_train_step", "make_select_step", "on_mesh", "PROXY_IMPLS"]

PROXY_IMPLS = ("auto", "einsum", "cuda", "torch")


def _mesh_of(params: dict):
    """The ``DeviceMesh`` of DTensor parameters, else None."""
    from torch.distributed.tensor import DTensor

    p = next(iter(params.values()))
    return p.device_mesh if isinstance(p, DTensor) else None


@contextlib.contextmanager
def on_mesh(params: dict):
    """The context a step runs in: nothing for plain parameters; for
    DTensor ones, plain tensors made inside count as replicated, and the
    parameters' mesh is the annotation mesh unless one is set."""
    mesh = _mesh_of(params)
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    pin = annotate.mesh_context(mesh) if annotate.get_mesh() is None else contextlib.nullcontext()
    with pin, implicit_replication():
        yield


def _split(v: torch.Tensor, n: int) -> tuple:
    """``torch.chunk`` along dim 0; a placed batch is gathered once and each
    block placed as ``v`` was (slicing a sharded dim gathers it anyway)."""
    from torch.distributed.tensor import DTensor

    chunks = torch.chunk(v, n, dim=0)
    if not isinstance(v, DTensor):
        return chunks
    return tuple(c.redistribute(v.device_mesh, v.placements) for c in chunks)


def _dp_dims(mesh) -> list:
    """The mesh dims that serve data parallelism alone."""
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n in ("pod", "data")]


def _gathered_over_dp(v: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter replicated over the data-parallel dims, its
    other placements kept; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(v, DTensor):
        return v
    dims = _dp_dims(v.device_mesh)
    target = tuple(Replicate() if i in dims else p for i, p in enumerate(v.placements))
    return v if target == tuple(v.placements) else v.redistribute(v.device_mesh, target)


def _with_placements(local: torch.Tensor, like, placements) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _per_replica(g: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient as each data-parallel replica's own: a pending sum
    over a data-parallel dim becomes a pending mean of the local tensor
    times that dim's size (``Partial("avg")``); a dim already whole is a
    mean of equal tensors.  A plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(g, DTensor):
        return g
    mesh, dims = g.device_mesh, _dp_dims(g.device_mesh)
    whole = [Replicate() if i in dims and not (p.is_partial() or p.is_replicate()) else p
             for i, p in enumerate(g.placements)]
    if whole != list(g.placements):
        g = g.redistribute(mesh, whole)
    sums = [i for i in dims if g.placements[i] == Partial("sum")]
    if any(g.placements[i].is_partial() and i not in sums for i in dims):
        raise ValueError(f"a gradient with placements {g.placements} has no replica form")
    n = math.prod(mesh.size(i) for i in sums)
    local = g.to_local() * n if n > 1 else g.to_local()
    return _with_placements(local, g, [Partial("avg") if i in dims else p
                                       for i, p in enumerate(g.placements)])


def _summed(g: torch.Tensor) -> torch.Tensor:
    """A pending mean left by the hook as the pending sum it equals (every
    backend reduces a sum)."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(g, DTensor) or Partial("avg") not in g.placements:
        return g
    n = math.prod(g.device_mesh.size(i) for i, p in enumerate(g.placements)
                  if p == Partial("avg"))
    return _with_placements(g.to_local() / n, g, [Partial("sum") if p == Partial("avg") else p
                                                  for p in g.placements])


def _placed_like(grads: dict, params: dict) -> dict:
    """Each DTensor gradient redistributed to its parameter's placements."""
    from torch.distributed.tensor import DTensor

    return {k: _summed(g).redistribute(params[k].device_mesh, params[k].placements)
            if isinstance(g, DTensor) and g.placements != params[k].placements else g
            for k, g in grads.items()}


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, microbatches: int = 1,
                    grad_transform: Callable[[Any], Any] | None = None) -> Callable:
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics); params and state are updated in place (see optimizers.py).
    ``grad_transform`` maps the gradient dict before the update (gradient
    compression; on a mesh, each replica's own gradients: the module's
    docstring)."""

    def grads_of(params, batch):
        names = list(params)
        if grad_transform is not None:  # each replica's own gradient for the hook
            params = {k: _gathered_over_dp(v) for k, v in params.items()}
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with spans.span("step.forward"):
            total, metrics = model_loss_fn(dict(zip(names, leaves)), cfg, batch)
        with spans.span("step.backward"):
            grads = torch.autograd.grad(total, leaves)
        return total.detach(), metrics, dict(zip(names, grads))

    def accumulated(params, batch):
        split = {k: _split(v, microbatches) for k, v in batch.items()}
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

    def step(params, opt_state: OptState, batch):
        if microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not divisible into {microbatches} microbatches")
            loss, metrics, grads = accumulated(params, batch)
        else:
            loss, metrics, grads = grads_of(params, batch)
        if grad_transform is not None:
            grads = grad_transform({k: _per_replica(g) for k, g in grads.items()})
        with spans.span("step.optimizer"):
            params, opt_state = optimizer.update(_placed_like(grads, params), opt_state, params)
        return params, opt_state, {
            "loss": loss,
            "aux_loss": metrics["aux_loss"].detach(),
            "step": opt_state.step,
        }

    def train_step(params, opt_state: OptState, batch):
        with on_mesh(params):
            return step(params, opt_state, batch)

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
        with on_mesh(params):
            if impl == "einsum":
                return proxy_features(params, cfg, batch)
            return proxy_features_fused(params, cfg, batch, impl=impl, **kw)

    return select_step
