"""Collective helpers: explicit reduce-scatter / all-gather gradient sync.

Port of ``repro.distributed.collectives``.  On a mesh of DTensors the
gradient reduction is implicit (the redistribution of each gradient to
its parameter's placements).  These are the explicit forms, for code that
holds plain local tensors a rank: ``reduce_scatter_mean`` in place of an
all-reduce, so an optimizer update runs on 1/|group| of each gradient
(ZeRO-2), and ``all_gather_params`` to rebuild the updated parameter.

``group`` is what ``torch.distributed``'s functional collectives take: a
``ProcessGroup``, a 1-D ``DeviceMesh``, or ``(DeviceMesh, dim)`` for one
dim of a mesh (its index or name).  The reference's axis name becomes the
group of that axis.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

__all__ = ["reduce_scatter_mean", "all_gather_params", "psum_mean", "group_size", "resolve"]


def resolve(group):
    """``group`` as the functional collectives take it: ``(mesh, dim)`` with
    the dim's index for its name."""
    if isinstance(group, tuple) and isinstance(group[1], str):
        mesh, name = group
        return mesh, mesh.mesh_dim_names.index(name)
    return group


def group_size(group) -> int:
    """The number of ranks in ``group``."""
    from torch.distributed.device_mesh import DeviceMesh

    group = resolve(group)
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.size(dim)
    if isinstance(group, DeviceMesh):
        return group.size()
    return dist.get_world_size(group)


def psum_mean(tree: Any, group) -> Any:
    """Each tensor of a dict (or one tensor) summed over ``group``, over its
    size."""
    n = group_size(group)

    def one(g):
        return funcol.wait_tensor(funcol.all_reduce(g, "sum", resolve(group))) / n

    return {k: one(v) for k, v in tree.items()} if isinstance(tree, dict) else one(tree)


def reduce_scatter_mean(x: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter over dim 0 (padded to the group size), mean
    semantics: rank r gets rows [r·m, (r+1)·m) of the padded sum over n."""
    n = group_size(group)
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    out = funcol.wait_tensor(funcol.reduce_scatter_tensor(x.contiguous(), "sum", 0, resolve(group)))
    return out / n


def all_gather_params(x: torch.Tensor, group, orig_dim0: int) -> torch.Tensor:
    """Inverse of :func:`reduce_scatter_mean`'s sharding (drops the dim-0
    padding)."""
    full = funcol.wait_tensor(funcol.all_gather_tensor(x.contiguous(), 0, resolve(group)))
    return full[:orig_dim0]
