"""Activation sharding annotations (logical-axis constraints).

Port of ``repro.distributed.annotate``.  Sharding propagation follows the
inputs' placements, but on a deep program it can pick a bad layout (a
replicated full-batch logit tensor after an op it cannot split), so the
models pin the layout of every major activation through this module.

``set_mesh(mesh)`` is called by whoever runs a step on a mesh (the dry
run, a launcher); ``constrain(x, *logical_axes)`` then redistributes a
DTensor ``x`` to divisibility-checked placements, as the reference's
``jax.lax.with_sharding_constraint``.  With no mesh set, or on a plain
tensor, it returns ``x`` itself, so model code annotates unconditionally
and the unsharded path is unchanged.  As in the reference, the gradient
of a pinned tensor is pinned to the same layout.  The setting is one for
the process, not a thread's as in the reference (whose tracing is one
thread): autograd runs a backward, and the recompute of a checkpointed
layer inside it, on a device thread of its own, which must place every
activation as the forward did.

Logical axis vocabulary:
  "batch" → (pod, data) [+ model under dp_over_model]   "tp" → model
  None → replicated; a mesh axis name → that axis.
"""
from __future__ import annotations

import math
import types
from typing import Optional

import torch

from repro_torch.distributed.sharding import mesh_shape, to_placements

__all__ = ["set_mesh", "get_mesh", "constrain", "mesh_context", "local_pointwise",
           "whole_heads", "per_shard", "pin_grad", "unsharded", "gate_halves"]

_STATE = types.SimpleNamespace(mesh=None, dp_over_model=False)


class _Pinned(torch.autograd.Function):
    """Forward: the DTensor redistributed to ``placements``.  Backward: the
    gradient redistributed to the same ``placements``, as the reference's
    ``with_sharding_constraint`` pins the cotangent alike.  DTensor's own
    ``redistribute`` would send the gradient back to the input's
    placements as it arrives — a partial sum, or a split that sharding
    propagation chose freely (a sequence split the next reshape cannot
    follow)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = tuple(placements)
        return _dense(x.redistribute(x.device_mesh, placements))

    @staticmethod
    def backward(ctx, g):
        # a partial sum's gradient may be placed as it comes on that dim
        target = tuple(q if p.is_partial() else p for p, q in zip(ctx.placements, g.placements))
        if tuple(g.placements) != target:
            g = g.redistribute(g.device_mesh, target)
        return _dense(g), None


def _dense(x):
    """A DTensor whose local shard is contiguous: a redistribution may leave
    a strided view of a buffer, which the views that DTensor's own
    decompositions take of the shard (an einsum's) cannot follow."""
    from torch.distributed.tensor import DTensor

    local = x._local_tensor
    if local.is_contiguous():
        return x
    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=_contiguous(x.shape))


def _contiguous(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()


def set_mesh(mesh, dp_over_model: bool = False) -> None:
    """``dp_over_model=True``: the ``model`` axis joins data parallelism —
    for throughput-oriented forward-only programs (the CRAIG select step),
    where ZeRO-3 weight gathers cost far less than per-layer tensor-parallel
    reductions."""
    _STATE.mesh = mesh
    _STATE.dp_over_model = dp_over_model


def get_mesh():
    return _STATE.mesh


class mesh_context:
    """Set ``mesh`` (and ``dp_over_model``) for the block, then restore the
    previous setting."""

    def __init__(self, mesh, dp_over_model: bool = False):
        self.mesh = mesh
        self.dp_over_model = dp_over_model

    def __enter__(self):
        self.prev = (get_mesh(), _STATE.dp_over_model)
        set_mesh(self.mesh, self.dp_over_model)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(*self.prev)
        return False


def _resolve(axis: Optional[str], mesh) -> tuple:
    names = set(mesh_shape(mesh))
    dp_over_model = _STATE.dp_over_model
    if axis is None:
        return ()
    if axis == "batch":
        dp = ("pod", "data", "model") if dp_over_model else ("pod", "data")
        return tuple(a for a in dp if a in names)
    if axis == "tp":
        if dp_over_model:
            return ()  # the model axis serves data parallelism
        return ("model",) if "model" in names else ()
    if axis in names:
        return (axis,)
    return ()


def constrain(x: torch.Tensor, *logical_axes: Optional[str], strict: bool = False):
    """Pin x's layout: one logical axis name (or None) per dimension.

    A dim shards when it is at least the axes' size (DTensor shards
    unevenly, as GSPMD pads); ``strict=True`` asks for exact divisibility,
    for dims that feed broadcast/reshape chains.
    """
    from torch.distributed.tensor import DTensor

    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"constrain: {len(logical_axes)} axes for shape {tuple(x.shape)}")
    sizes = mesh_shape(mesh)
    spec = []
    for dim, axis in zip(x.shape, logical_axes):
        group = _resolve(axis, mesh)
        size = math.prod(sizes[g] for g in group) if group else 1
        ok = dim % size == 0 if strict else dim >= size
        spec.append((group if len(group) > 1 else group[0]) if group and ok else None)
    placements = to_placements(tuple(spec), mesh)
    if tuple(x.placements) == placements:
        return x
    return _Pinned.apply(x, placements)


def local_pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``.  On a DTensor ``fn`` runs on each
    device's own shard (``local_map``), with a partial sum reduced first:
    for ops whose backward has no sharding strategy (``log_sigmoid``)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x, DTensor):
        return fn(x)
    placements = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(fn, out_placements=placements, in_placements=(placements,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def whole_heads(y: torch.Tensor, h: int) -> torch.Tensor:
    """``y`` (…, h·k) itself, or for a DTensor, ``y`` with no head across
    devices: its last dim gathered where it is split over more devices
    than divide ``h``, and its gradient pinned to that layout.  Put it
    next to every reshape between (…, h, k) and (…, h·k): a product with a
    weight replicated on that dim may split its output there, and a
    gradient may arrive split so (its reshape back into heads then
    fails)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(y, DTensor):
        return y
    last = Shard(y.dim() - 1)
    split = [i for i, p in enumerate(y.placements) if p == last]
    placements = tuple(y.placements)
    if split and h % math.prod(y.device_mesh.size(i) for i in split):
        placements = tuple(Replicate() if p == last else p for p in placements)
    return _Pinned.apply(y, placements)


def per_shard(fn, x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``fn(x, *others)`` for a function whose output has ``x``'s shape and
    is computed independently along the dims ``x`` is split on (batch and
    heads for attention).  On a DTensor ``x`` it runs on each device's own
    shards, ``others`` placed as ``x``, and its output is placed as ``x``
    with ``x``'s global shape: uneven splits (28 heads over 16) included,
    which ``local_map`` cannot place.  DTensor's own batched products
    merge a batch split with a head split into a strided split its fake
    tensors cannot propagate."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return fn(x, *others)
    mesh, placements = x.device_mesh, tuple(x.placements)
    locals_ = [t if tuple(t.placements) == placements else t.redistribute(mesh, placements)
               for t in others]
    out = fn(x.to_local(), *(t.to_local() for t in locals_)).contiguous()
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=x.shape,
                              stride=_contiguous(x.shape))


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself in the forward; on a DTensor its gradient redistributed
    to ``x``'s placements, for a reshape just before whose backward cannot
    follow the gradient's split (the GQA repeat of the KV heads)."""
    from torch.distributed.tensor import DTensor

    return _Pinned.apply(x, tuple(x.placements)) if isinstance(x, DTensor) else x


def unsharded(params: dict) -> dict:
    """Weights as their products take them on a mesh: each DTensor gathered
    over every mesh dim but ``model`` (ZeRO-3 over the data axes), its
    ``model`` split kept (gathered too under ``dp_over_model``, where the
    model axis serves the batch), by DTensor's own ``redistribute``, whose
    backward reduce-scatters the gradient back to the weight's placements.
    The target follows from the weight's own placements.  Left to sharding
    propagation, a product with a weight split on its contraction dim may
    gather the batch instead.  Plain tensors and no mesh leave ``params``
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if get_mesh() is None:
        return params
    out = {}
    for k, v in params.items():
        if isinstance(v, DTensor):
            names = v.device_mesh.mesh_dim_names
            target = tuple(p if names[i] == "model" and not _STATE.dp_over_model else Replicate()
                           for i, p in enumerate(v.placements))
            if tuple(v.placements) != target:
                v = v.redistribute(v.device_mesh, target)
        out[k] = v
    return out


def gate_halves(w: torch.Tensor, rows: int):
    """For a gated weight (D, 2F) split over devices on its last dim, taken
    by ``rows`` input rows: its gate and up halves, each split the same
    way on its own; else None.  A split output of the whole weight holds
    gate columns on half the devices and up columns on the other half, and
    pairing them moves activations; the halves move the weight instead
    (DTensor gathers the sliced dim) and keep every product local, the
    cheaper when the rows outnumber D (training, prefill; not decode)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(w, DTensor) or rows < w.shape[-2]:
        return None
    last = Shard(w.dim() - 1)
    if not any(p == last and w.device_mesh.size(i) > 1 for i, p in enumerate(w.placements)):
        return None
    n = w.shape[-1] // 2
    return tuple(h.redistribute(w.device_mesh, w.placements) for h in (w[..., :n], w[..., n:]))
