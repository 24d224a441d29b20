"""The port's sharding rules (``distributed/sharding.py``) against the
reference's, spec for spec, for all ten archs on both production meshes.

The reference's functions read only a mesh's axis names and sizes, so they
run on ``jax.sharding.AbstractMesh``es of the production shapes and on
``jax.eval_shape`` trees (no devices, no arrays).  Its parameter tree
stacks the full pattern periods (a leading layer axis) and stores the
unembedding (D, V); the port's has one tensor a layer and a vocab-major
(V, D) unembedding (``convert.model_params_from_reference``), so the
reference's specs are mapped the same way: the stack axis dropped, the
unembedding's last two entries swapped.  The optimizer-state, serving,
batch and serve-state specs are held the same way; the serve-state
heuristic, shape-driven per tensor, is the reference's function applied to
the port's per-layer states (those ``convert.serve_state_from_reference``
gives).  ``to_placements`` is checked on a fake 16×16 ``DeviceMesh``.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs.registry import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.models import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import init_serve_state, param_shapes
from repro_torch.optim import adamw
import torch_threads  # noqa: F401 — one intra-op thread a worker

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names)


def _entry(a):
    if isinstance(a, (tuple, list)):
        a = tuple(a)
        return a if len(a) > 1 else (a[0] if a else None)
    return a


def _norm(spec, ndim):
    """A reference PartitionSpec as the port's tuple, padded to ``ndim``."""
    return tuple(_entry(a) for a in spec) + (None,) * (ndim - len(spec))


def _key(p):
    return str(getattr(p, "key", getattr(p, "idx", p)))


def _by_port_name(tree, spec_tree, cfg) -> dict:
    """{port name: spec} from the reference's parameter tree and its spec
    tree: stacked periods unstacked, the unembedding transposed."""
    period = len(cfg.block_pattern)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    n_full = cfg.n_layers // period
    out = {}
    for (path, leaf), spec in zip(leaves, specs):
        parts = [_key(p) for p in path]
        s = _norm(spec, leaf.ndim)
        if parts[:2] == ["stack", "scanned"]:
            i, rest = int(parts[2]), ".".join(parts[3:])
            for j in range(n_full):
                out[f"layers.{j * period + i}.{rest}"] = s[1:]
        elif parts[:2] == ["stack", "remainder"]:
            out[f"layers.{n_full * period + int(parts[2])}.{'.'.join(parts[3:])}"] = s
        elif parts == ["unembed"]:
            out["unembed"] = s[:-2] + (s[-1], s[-2])
        else:
            out[".".join(parts)] = s
    return out


def _reference_params(arch):
    return jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jget_config(arch)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_state_specs_are_the_references(arch, mesh):
    cfg, m = get_config(arch), _mesh(mesh)
    tree = _reference_params(arch)
    shapes = param_shapes(cfg)
    want = _by_port_name(tree, jshd.param_specs(tree, m), cfg)
    got = shd.param_specs(shapes, m)
    assert set(got) == set(want)
    assert got == want
    # serving: no ZeRO-3
    want_serve = _by_port_name(tree, jshd.serve_param_specs(tree, m), cfg)
    assert shd.serve_param_specs(shapes, m) == want_serve
    assert all("data" not in str(s) for s in want_serve.values())
    # AdamW's moments like their parameters, the step replicated
    jopt = jax.eval_shape(jadamw(lambda s: 1e-3).init, tree)
    jstate = jshd.state_shardings(jopt, jshd.param_specs(tree, m), m)
    state = shd.state_shardings(adamw(lambda s: 1e-3).init(
        {k: torch.empty(s, device="meta") for k, s in shapes.items()}), got, m)
    assert _norm(jstate.step.spec, 0) == state.step
    for moment in ("m", "v"):
        specs = jax.tree.map(lambda s: s.spec, jstate.inner[moment])
        assert _by_port_name(tree, specs, cfg) == state.inner[moment]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_are_the_references(mesh):
    m = _mesh(mesh)
    for arch in ("qwen3-1.7b", "qwen2-vl-7b", "musicgen-medium"):
        cfg = get_config(arch)
        for shape in list(SHAPES.values()) + [dryrun.SELECT_POOL]:
            struct = (dryrun.infer_batch_struct(cfg, shape, shape.kind == "decode")
                      if shape.kind in ("prefill", "decode")
                      else dryrun.train_batch_struct(cfg, shape))
            shapes = {k: s for k, (s, _) in struct.items()}
            jstruct = {k: jax.ShapeDtypeStruct(s, "float32") for k, s in shapes.items()}
            for kw in ({}, {"seq_shard": True}, {"dp_over_model": True},
                       {"seq_shard": True, "dp_over_model": True}):
                want = {k: _norm(s, len(shapes[k]))
                        for k, s in jshd.batch_specs(m, jstruct, **kw).items()}
                assert shd.batch_specs(m, shapes, **kw) == want, (arch, shape.name, kw)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_state_specs_are_the_references(arch, mesh):
    cfg, m = get_config(arch), _mesh(mesh)
    for shape in ("decode_32k", "long_500k"):
        B, L = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        state = init_serve_state(cfg, B, L, "meta")
        jlayers = [{k: jax.ShapeDtypeStruct(tuple(t.shape), "float32") for k, t in lay.items()}
                   for lay in state["layers"]]
        want = jax.tree.map(lambda s: _norm(s.spec, 0), jshd.serve_state_specs(jlayers, m, B),
                            is_leaf=lambda x: hasattr(x, "spec"))
        got = shd.serve_state_specs(state, m, B)
        assert got["layers"] == [{k: tuple(v) for k, v in lay.items()} for lay in want]
        assert got["pos"] == 0


def test_to_placements_on_a_fake_16x16_mesh():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(256, "cpu"):
        mesh = make_production_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)
        assert shd.to_placements((None, ("data", "model")), mesh) == (Shard(1), Shard(1))
        assert shd.to_placements(("model", "data"), mesh) == (Shard(1), Shard(0))
        assert shd.to_placements((None, None), mesh) == (Replicate(), Replicate())
        assert shd.logical_to_sharding(mesh, ("data", None)) == (Shard(0), Replicate())
        with pytest.raises(ValueError, match="order"):
            shd.to_placements((("model", "data"),), mesh)
        with pytest.raises(ValueError, match="512 ranks; the process group has 256"):
            make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="boom"), fake_world(4, "cpu"):
        raise RuntimeError("boom")
    assert not torch.distributed.is_initialized()  # destroyed on the error too
