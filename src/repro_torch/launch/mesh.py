"""Device meshes of the port.

Port of ``repro.launch.mesh``.  JAX's ``shard_map`` is single-controller:
one process drives every device of a mesh, and the collectives
(``all_gather``, ``psum``) run over a named axis.  The port keeps that
model without emulating ``shard_map``: a :class:`Mesh` is an object array
of ``torch.device``s with named axes, and the distributed bodies
(``core.distributed``, ``distributed.tree_select``, the data-parallel
extract in ``core.extract``) are explicit stages over its shards, each
shard's work on that shard's device.  A mesh may name one device several
times: a 4-shard mesh on one card is four entries of ``cuda:0``, as the
reference's CPU tests force eight host devices.  A multi-process mesh (one
rank per card over NCCL) is a later item (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["Mesh", "compat_mesh", "make_host_mesh", "make_production_mesh"]

_MULTI_GPU_ITEM = "ROADMAP.md queue 1, 'Model parallelism and multi-GPU meshes'"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An n-d array of devices with one name per axis.

    Attributes:
      devices: object array of ``torch.device``, one dim per axis.
      axis_names: the axes, major first.
    """

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if devs.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {devs.shape} needs {devs.ndim} axis names, got "
                f"{self.axis_names}"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axis names {self.axis_names}")
        flat = [torch.device(d) for d in devs.reshape(-1)]
        out = np.empty(len(flat), dtype=object)
        out[:] = flat
        object.__setattr__(self, "devices", out.reshape(devs.shape))

    @property
    def shape(self) -> dict[str, int]:
        """Ordered axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> list[torch.device]:
        """Every entry, row-major (the last axis minor)."""
        return list(self.devices.reshape(-1))

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along ``axis_name`` at coordinate 0 of every other
        axis: the shards of a computation mapped over that axis alone,
        replicated over the others."""
        if axis_name not in self.axis_names:
            raise ValueError(
                f"mesh axes {self.axis_names} have no axis {axis_name!r}"
            )
        ax = self.axis_names.index(axis_name)
        index = [0] * len(self.axis_names)
        index[ax] = slice(None)
        return list(self.devices[tuple(index)])


def compat_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: every visible card;
    raises without one), repeated in order, since one device may serve
    several shards."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("compat_mesh needs at least one device")
    if len(devices) != n and n % len(devices):
        raise ValueError(
            f"compat_mesh: {len(devices)} devices do not tile a mesh of {n} "
            f"shards {shape}"
        )
    flat = np.empty(n, dtype=object)
    flat[:] = [devices[i % len(devices)] for i in range(n)]
    return Mesh(flat.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's v5e 16×16 (or 2×16×16) mesh has no counterpart yet."""
    raise NotImplementedError(
        "the production mesh spans 256 (or 512) accelerators; the port runs "
        f"one process per mesh so far ({_MULTI_GPU_ITEM})"
    )


def make_host_mesh(device: str | torch.device = "cpu") -> Mesh:
    """1-device mesh with the production axis names (CPU tests)."""
    return compat_mesh((1, 1), ("data", "model"), devices=[device])
