"""AdamW over a whole parameter dict on a card: the CUDA launch wrappers.

Replaces no TPU kernel: the reference (``repro.optim.optimizers.adamw``)
leaves its elementwise update to XLA's fusion.  The port's optimizer
(:func:`repro_torch.optim.adamw`) calls :func:`adamw_update_cuda` when the
parameters are on a card, and its plain loop
(:func:`repro_torch.optim.optimizers.adamw_loop`, the twin) anywhere else.
It launches one ``adamw_sq_norm`` for the global-norm clip (when ``clip``
is set) and one ``adamw_update`` for the step, over every leaf at once,
each element read once; or raises (fp32 leaves only, and contiguous
parameters and moments).

The kernels walk a list of chunks ((leaf, start, stop) of at most
:data:`CHUNK` elements), built on the host once for each signature of leaf
sizes (:func:`chunk_list`) and kept on the device.  Each launch carries the
step's leaf pointers by value, :data:`MAX_LEAVES` leaves at most: more
leaves take one launch for each :data:`MAX_LEAVES` of them.

Both passes are custom ops (``torch.ops.repro_torch.adamw_sq_norm``,
``adamw_update``) with fake implementations, so that a dry run traces the
step on fake tensors of the card's device type and launches nothing.  On a
DTensor mesh they run on each device's local shards; the norm's partial
sums of a leaf group sharded over some mesh dims are summed over those dims
(an all-reduce) before the update reads them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.kernels.fl_gains import _stream

__all__ = ["LAUNCHES", "CHUNK", "MAX_LEAVES", "NORM_BLOCKS", "chunk_list", "leaf_runs",
           "adamw_update_cuda"]

LAUNCHES = _build.LAUNCHES

CHUNK = 1 << 16  # elements a chunk: a CTA's unit of work
MAX_LEAVES = 512  # leaves a launch carries (csrc/adamw.cu::MAX_LEAVES)
NORM_BLOCKS = 1024  # CTAs of the norm pass, one fp32 partial sum each


def chunk_list(numels, chunk: int = CHUNK) -> np.ndarray:
    """(n, 3) int64 rows (leaf, start, stop): every element of every leaf
    exactly once, in leaf order, at most ``chunk`` elements a row; a leaf of
    no elements has no row."""
    sizes = np.asarray(numels, dtype=np.int64).reshape(-1)
    counts = -(-sizes // chunk)
    first = np.cumsum(counts) - counts
    leaf = np.repeat(np.arange(len(sizes), dtype=np.int64), counts)
    start = (np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(first, counts)) * chunk
    stop = np.minimum(start + chunk, np.repeat(sizes, counts))
    return np.stack([leaf, start, stop], axis=1)


def leaf_runs(n_leaves: int, max_leaves: int = MAX_LEAVES) -> list[tuple[int, int]]:
    """The (lo, hi) leaf ranges of one launch each."""
    return [(lo, min(lo + max_leaves, n_leaves)) for lo in range(0, n_leaves, max_leaves)]


@functools.lru_cache(maxsize=8)
def _plan(device: torch.device, numels: tuple) -> tuple:
    """Each launch's (lo, hi, device chunk list, chunks), cached by leaf sizes."""
    out = []
    for lo, hi in leaf_runs(len(numels)):
        chunks = chunk_list(numels[lo:hi])
        out.append((lo, hi, torch.from_numpy(chunks).to(device), len(chunks)))
    return tuple(out)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library("adamw")
    if lib.adamw_max_leaves() != MAX_LEAVES:
        raise RuntimeError(f"csrc/adamw.cu carries {lib.adamw_max_leaves()} leaves a launch, "
                           f"kernels/adamw.py expects {MAX_LEAVES}")
    return lib


def _table(*leaf_lists) -> ctypes.Array:
    """The host pointer table of a launch: every list's pointers in turn."""
    ptrs = [t.data_ptr() for leaves in leaf_lists for t in leaves]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


@torch.library.custom_op("repro_torch::adamw_sq_norm", mutates_args=(), device_types="cuda")
def _sq_norm_op(grads: list[torch.Tensor]) -> torch.Tensor:
    """NORM_BLOCKS fp32 partial sums of g·g a launch, whose sum is the
    squared norm of all ``grads``."""
    dev = grads[0].device
    runs = _plan(dev, tuple(g.numel() for g in grads))
    partials = torch.empty(len(runs) * NORM_BLOCKS, dtype=torch.float32, device=dev)
    lib, stream = _library(), _stream(dev)
    for i, (lo, hi, chunks, n_chunks) in enumerate(runs):
        table = _table(grads[lo:hi])
        status = lib.adamw_sq_norm_f32(
            ctypes.addressof(table), hi - lo, chunks.data_ptr(), n_chunks,
            partials.data_ptr() + 4 * i * NORM_BLOCKS, NORM_BLOCKS, stream)
        _build.check(status, "adamw_sq_norm")
        LAUNCHES["adamw_sq_norm"] += 1
    return partials


@_sq_norm_op.register_fake
def _(grads):
    return grads[0].new_empty((len(leaf_runs(len(grads))) * NORM_BLOCKS,),
                              dtype=torch.float32)


@torch.library.custom_op("repro_torch::adamw_update", mutates_args=("params", "m", "v"),
                         device_types="cuda")
def _update_op(params: list[torch.Tensor], m: list[torch.Tensor], v: list[torch.Tensor],
               grads: list[torch.Tensor], partials: Optional[torch.Tensor], lr: float,
               b1: float, b2: float, bc1: float, bc2: float, eps: float,
               weight_decay: float, clip: float) -> None:
    """One AdamW step over every leaf, in place; clipped by the norm whose
    squared partial sums are ``partials`` (None: no clip)."""
    dev = params[0].device
    runs = _plan(dev, tuple(p.numel() for p in params))
    lib, stream = _library(), _stream(dev)
    part = 0 if partials is None else partials.data_ptr()
    n_part = 0 if partials is None else partials.numel()
    f = ctypes.c_float
    for lo, hi, chunks, n_chunks in runs:
        table = _table(params[lo:hi], m[lo:hi], v[lo:hi], grads[lo:hi])
        status = lib.adamw_update_f32(
            ctypes.addressof(table), hi - lo, chunks.data_ptr(), n_chunks, part, n_part,
            f(lr), f(b1), f(1 - b1), f(b2), f(1 - b2), f(bc1), f(bc2), f(eps),
            f(weight_decay), f(clip), stream)
        _build.check(status, "adamw_update")
        LAUNCHES["adamw_update"] += 1


@_update_op.register_fake
def _(params, m, v, grads, partials, lr, b1, b2, bc1, bc2, eps, weight_decay, clip):
    return None


def _local_leaves(name: str, p, g, m, v) -> tuple:
    """The four tensors the kernels update for leaf ``name`` (each device's
    local shard of a DTensor), checked; and the mesh dims it is split on."""
    dims, mesh = (), None
    if isinstance(p, DTensor):
        mesh = p.device_mesh
        if any(pl.is_partial() for pl in p.placements):
            raise ValueError(f"AdamW leaf {name!r} has a pending reduction {p.placements}")
        dims = tuple(i for i, pl in enumerate(p.placements) if pl.is_shard())
        for t, what in ((g, "gradient"), (m, "m"), (v, "v")):
            if not isinstance(t, DTensor) or t.placements != p.placements:
                raise ValueError(f"AdamW leaf {name!r}: its {what} is not placed as the "
                                 f"parameter ({p.placements})")
        p, g, m, v = (t.to_local() for t in (p, g, m, v))
    # autograd may hand a gradient back in another layout (xlstm-1.3b's
    # r_in): that leaf's gradient is copied into the parameter's
    local = (p, g.contiguous(), m, v)
    if not all(t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
               and t.shape == p.shape for t in local):
        _refuse(name, local)
    return local, dims, mesh


def _refuse(name: str, local: tuple) -> None:
    """Raise for the first of a leaf's tensors the kernels cannot take."""
    for t, what in zip(local, ("parameter", "gradient", "m", "v")):
        if not t.is_cuda:
            raise ValueError(f"the AdamW CUDA kernels take CUDA tensors; the {what} of "
                             f"{name!r} is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the AdamW CUDA kernels take fp32 leaves; the {what} of "
                             f"{name!r} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the AdamW CUDA kernels take contiguous leaves; the {what} "
                             f"of {name!r} is not")
        if t.shape != local[0].shape:
            raise ValueError(f"the {what} of {name!r} has shape {tuple(t.shape)}, the "
                             f"parameter {tuple(local[0].shape)}")


@torch.no_grad()
def adamw_update_cuda(params: dict, grads: dict, m: dict, v: dict, *, lr: float, b1: float,
                      b2: float, bc1: float, bc2: float, eps: float, weight_decay: float,
                      clip: float | None) -> None:
    """One AdamW step over every leaf through the kernels, in place on
    ``params``, ``m`` and ``v``; ``grads`` are read, not written."""
    leaves = []
    groups: dict[tuple, list] = {}  # (mesh, the dims a leaf is split on) -> positions
    for i, k in enumerate(params):
        local, dims, mesh = _local_leaves(k, params[k], grads[k], m[k], v[k])
        leaves.append(local)
        groups.setdefault((mesh, dims), []).append(i)
    if not leaves:
        return
    P, G, M, V = (list(t) for t in zip(*leaves))
    partials = None
    if clip is not None:
        rows = []
        for (mesh, dims), pos in groups.items():
            row = _sq_norm_op([G[i] for i in pos])
            for d in dims:  # the other shards' sums of the same leaves
                row = funcol.wait_tensor(funcol.all_reduce(row, "sum", (mesh, d)))
            rows.append(row)
        partials = rows[0] if len(rows) == 1 else torch.cat(rows)
    _update_op(P, M, V, G, partials, float(lr), b1, b2, bc1, bc2, eps, weight_decay,
               0.0 if clip is None else float(clip))
