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
reference's CPU tests force eight host devices.

Model parallelism takes the other model: one process a rank, over
``torch.distributed``.  :func:`make_production_mesh` is the reference's
16×16 ``("data", "model")`` (or 2×16×16 ``("pod", "data", "model")``) mesh
as a ``DeviceMesh`` over the initialised process group, whose placements
``distributed/sharding.py`` computes; :func:`fake_world` initialises
PyTorch's fake backend, under which one process holds a mesh of any
size and traces a sharded step on fake tensors (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["Mesh", "compat_mesh", "make_host_mesh", "make_production_mesh", "fake_world",
           "PRODUCTION_MESHES"]

# mesh kind → (shape, axis names), the reference's
PRODUCTION_MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


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


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh as a ``DeviceMesh`` of
    ``device_type`` over the initialised process group: 16×16 ("data",
    "model"), or 2×16×16 ("pod", "data", "model") with ``multi_pod``.

    Raises:
      RuntimeError: no process group is initialised.
      ValueError: its world size is not the mesh's 256 (or 512) ranks.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = PRODUCTION_MESHES["multi" if multi_pod else "single"]
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or fake_world)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the {'×'.join(map(str, shape))} production mesh needs {n} ranks; "
                         f"the process group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


@contextlib.contextmanager
def fake_world(world_size: int, device_type: str = "cuda"):
    """A process group of ``world_size`` ranks on PyTorch's fake backend,
    this process rank 0, for the block: a mesh of that size lives in one
    process and a step on it traces with every collective's shapes, moving
    no data.  ``device_type`` is checked as an entry point checks its
    device (``cuda`` raises without a card).  The group is destroyed on
    exit, error or not."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    resolve_device(device_type)
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(device: str | torch.device = "cpu") -> Mesh:
    """1-device mesh with the production axis names (CPU tests)."""
    return compat_mesh((1, 1), ("data", "model"), devices=[device])
