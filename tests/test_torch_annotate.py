"""The port's activation constraints (``distributed/annotate.py``) against
the reference's.

``_resolve`` maps every logical axis to the reference's mesh axes, with
and without ``dp_over_model``, on the host mesh and both production
meshes (``AbstractMesh``es: the reference reads names and sizes alone).
``constrain`` returns its argument itself without a mesh or on a plain
tensor; on a fake 16×16 mesh it places a DTensor by the reference's rule
(a dim shards when at least the axes' size, or divisible under
``strict``) and pins the gradient to the same placements.
"""
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.distributed import annotate as jann
from repro_torch.distributed import annotate as ann
from repro_torch.launch.mesh import fake_world, make_production_mesh
import torch_threads  # noqa: F401 — one intra-op thread a worker

MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
AXES = [None, "batch", "tp", "data", "model", "pod", "seq"]


@pytest.mark.parametrize("dp_over_model", [False, True])
@pytest.mark.parametrize("shape,names", MESHES)
def test_resolve_is_the_references(shape, names, dp_over_model):
    mesh = AbstractMesh(shape, names)
    jann.set_mesh(mesh, dp_over_model=dp_over_model)
    ann.set_mesh(mesh, dp_over_model=dp_over_model)
    try:
        for axis in AXES:
            assert ann._resolve(axis, mesh) == jann._resolve(axis, mesh), axis
    finally:
        jann.set_mesh(None)
        ann.set_mesh(None)


def test_constrain_without_a_mesh_or_on_a_plain_tensor_is_the_identity():
    x = torch.randn(4, 3)
    assert ann.get_mesh() is None
    assert ann.constrain(x, "batch", "tp") is x
    with ann.mesh_context(AbstractMesh((16, 16), ("data", "model"))):
        assert ann.constrain(x, "batch", "tp") is x
    assert ann.get_mesh() is None


def test_constrain_places_a_dtensor_and_pins_its_gradient():
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    with fake_world(256, "cpu"):
        mesh = make_production_mesh(device_type="cpu")
        x = distribute_tensor(torch.zeros(32, 28, 24), mesh, [Replicate(), Replicate()])
        with ann.mesh_context(mesh):
            # 28 heads over 16: uneven is allowed, as GSPMD pads; strict is not
            assert ann.constrain(x, "batch", "tp", None).placements == (Shard(0), Shard(1))
            assert ann.constrain(x, "batch", "tp", None, strict=True).placements == (
                Shard(0), Replicate())
            assert ann.constrain(x, None, None, None) is x
            with pytest.raises(ValueError, match="2 axes"):
                ann.constrain(x, "batch", None)
            leaf = x.detach().requires_grad_(True)
            y = ann.constrain(leaf, "batch", None, "tp")
            assert y.placements == (Shard(0), Shard(2))
            (g,) = torch.autograd.grad(y, leaf, grad_outputs=distribute_tensor(
                torch.ones(32, 28, 24), mesh, [Replicate(), Replicate()]))
            assert isinstance(g, DTensor) and g.placements == (Shard(0), Shard(2))
        with ann.mesh_context(mesh, dp_over_model=True):
            # the model axis joins the batch's (256 ways: 32 rows stay whole)
            assert ann.constrain(x, "batch", "tp", None).placements == (
                Replicate(), Replicate())
            rows = distribute_tensor(torch.zeros(256, 4), mesh, [Replicate(), Replicate()])
            assert ann.constrain(rows, "batch", "tp").placements == (Shard(0), Shard(0))
