"""Seeded fp32 weights in the port's parameter layout, made on the device.

Each weight group (a layer, the embedding, the head) is one flat buffer
filled by one ``normal_`` call of a ``torch.Generator`` on the device,
seeded from ``--seed`` and the group's name; the leaves are views of it,
clamped to [−2, 2] and scaled by 1/√fan_in (the port's ``dense_init``
draws a truncated normal with that scale).  Norm scales are ones and
biases zeros.  A group can be drawn again alone (:func:`group`), so a
check can recompute the initial weights of one group at a time instead
of keeping a copy of all of them.
"""
from __future__ import annotations

import math

import torch

from perfbench.corpus import derive_seed
from perfbench.model_shape import Shape

__all__ = ["make_params", "group", "groups"]


def groups(shape: Shape) -> dict[str, list]:
    """Group name → its leaves (name, shape, init, fan), in layout order."""
    out: dict[str, list] = {}
    for leaf in shape.leaves():
        out.setdefault(shape.group_of(leaf[0]), []).append(leaf)
    return out


def group(shape: Shape, seed: int, name: str, device, leaves=None) -> dict[str, torch.Tensor]:
    """The leaves of group ``name`` as made for ``seed`` (views of one buffer)."""
    leaves = groups(shape)[name] if leaves is None else leaves
    drawn = [(n, s, f) for n, s, kind, f in leaves if kind == "normal"]
    total = sum(math.prod(s) for _, s, _ in drawn)
    out: dict[str, torch.Tensor] = {}
    if total:
        gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights", name))
        flat = torch.empty(total, dtype=torch.float32, device=device)
        flat.normal_(generator=gen).clamp_(-2.0, 2.0)
        lo = 0
        for n, s, fan in drawn:
            size = math.prod(s)
            out[n] = flat[lo:lo + size].view(s).mul_(1.0 / math.sqrt(fan))
            lo += size
    for n, s, kind, _ in leaves:
        if kind == "ones":
            out[n] = torch.ones(s, dtype=torch.float32, device=device)
        elif kind == "zeros":
            out[n] = torch.zeros(s, dtype=torch.float32, device=device)
    return {n: out[n] for n, _, _, _ in leaves}


def make_params(shape: Shape, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter, in the port's layout and order."""
    params: dict[str, torch.Tensor] = {}
    for name, leaves in groups(shape).items():
        params.update(group(shape, seed, name, device, leaves))
    return {n: params[n] for n, _, _, _ in shape.leaves()}
