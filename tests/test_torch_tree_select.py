"""Port tree selection (``repro_torch.distributed.tree_select``) against the
reference's (``repro.distributed.tree_select``), on the CPU, and its
drivers against each other.

Against the reference: the tree is replayed stage by stage in both
packages and each leaf and merge round held to the tie rule
(``tests/test_torch_distributed.py``: ``replay``, ``hold_stages``,
``hold_final``); with no divergence indices and γ are equal and coverage
within rtol 1e-4 + r·τ.  Within the port: the mesh driver equals the
host driver, and the ``(n_shards,)`` tree on the fp32 wire equals
``distributed_select``, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.craig import CraigConfig as JCraigConfig
from repro.core.craig import CraigSelector as JCraigSelector
from repro.distributed import tree_select as JT
from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.core import engines as E
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.distributed import tree_select as T
from test_torch_distributed import ENGINES, cpu_mesh, hold_final, hold_stages, replay, root_of
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker


def _pool(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_topology_config_and_wire_plan_equal_the_reference():
    for fo in ((8,), (2, 2), (4, 2), (3, 1, 2)):
        t, jt = T.TreeTopology(fo), JT.TreeTopology(fo)
        assert (t.depth, t.n_leaves, t.axis_names) == (jt.depth, jt.n_leaves, jt.axis_names)
        assert [t.nodes_at(lv) for lv in range(t.depth + 1)] == [
            jt.nodes_at(lv) for lv in range(jt.depth + 1)]
        assert T.TreeTopology.from_dict(t.to_dict()) == t
        for compress in T.WIRE_MODES:
            assert T.wire_bytes_plan(t, 24, 40, 54, compress) == JT.wire_bytes_plan(
                jt, 24, 40, 54, compress)
    assert T.default_r_node(12, 30) == JT.default_r_node(12, 30) == 30
    for bad in ((), (1, 1), (0, 2)):
        with pytest.raises(ValueError):
            T.TreeTopology(bad)
    with pytest.raises(ValueError, match="not a wire mode"):
        T.TreeSelectConfig(compress="fp16")


@pytest.mark.parametrize("compress", ["int8", "none"])
@pytest.mark.parametrize("fanouts", [(2, 2), (4, 2)])
@pytest.mark.parametrize("n", [1024, 1021])
def test_host_driver_matches_reference(fanouts, compress, n):
    x = _pool(1024, 16, seed=0)[:n]
    ref_sel = JT.tree_select_host(jnp.asarray(x), JT.TreeTopology(fanouts), 12, 16,
                                  compress=compress)
    got = T.tree_select_host(x, T.TreeTopology(fanouts), 12, 16, compress=compress)
    assert got.wire == ref_sel.wire and got.health is None
    ref_st = replay("ref", x, fanouts, 12, 16, compress, ENGINES["matrix"][0])
    got_st = replay("port", x, fanouts, 12, 16, compress, E.MatrixConfig())
    np.testing.assert_array_equal(root_of(ref_st), np.asarray(ref_sel.indices))
    np.testing.assert_array_equal(root_of(got_st), got.indices.numpy())
    hold_final(x, ref_sel, got, hold_stages(ref_st, got_st), 16)


@pytest.mark.parametrize("engine", ["matrix", "device", "sparse"])
@pytest.mark.parametrize("compress", ["int8", "none"])
def test_mesh_driver_equals_host_driver(engine, compress):
    x = _pool(1024, 12, seed=2)
    topo = T.TreeTopology((4, 2))
    pe = ENGINES[engine][1]
    host = T.tree_select_host(x, topo, 12, 20, local_engine=pe, compress=compress)
    mesh = T.tree_mesh(topo, ["cpu"] * 8)
    assert mesh.shape == {"lvl1": 2, "lvl0": 4}
    got = T.tree_select_mesh(torch.as_tensor(x), mesh, topo, 12, 20, local_engine=pe,
                             compress=compress)
    assert torch.equal(got.indices, host.indices) and torch.equal(got.weights, host.weights)
    assert float(got.coverage) == float(host.coverage) and got.wire == host.wire
    assert float(got.weights.sum()) == 1024


@pytest.mark.parametrize("engine", ["matrix", "features", "sparse"])
def test_one_level_fp32_tree_equals_distributed_select(engine):
    x = torch.as_tensor(_pool(768, 8, seed=3))
    pe = ENGINES[engine][1]
    tree = T.tree_select_host(x, T.TreeTopology((4,)), 16, 30, local_engine=pe,
                              compress="none")
    two = D.distributed_select(x, cpu_mesh(4), 16, 30, local_engine=pe)
    assert torch.equal(tree.indices, two.indices) and torch.equal(tree.weights, two.weights)
    assert float(tree.coverage) == float(two.coverage)


def test_select_tree_provenance_round_trips_and_equals_the_reference():
    x = _pool(512, 8, seed=4)
    want = JCraigSelector(JCraigConfig(fraction=0.05, per_class=False)).select_tree(
        jnp.asarray(x), (2, 2), compress="int8")
    sel = CraigSelector(CraigConfig(fraction=0.05, per_class=False), device="cpu")
    got = sel.select_tree(x, (2, 2), compress="int8")
    ref_engine = dict(want.engine)
    ref_engine["local"] = convert.engine_config_from_reference(ref_engine["local"]).to_dict()
    assert got.engine == {**ref_engine, "fanouts": tuple(ref_engine["fanouts"]),
                          "missing_pids": tuple(ref_engine["missing_pids"])}
    restored = E.engine_config_from_dict(got.engine)
    assert isinstance(restored, T.TreeSelectConfig) and restored.to_dict() == got.engine
    assert restored.topology == T.TreeTopology((2, 2)) and restored.local["name"] == "matrix"
    assert got.size == 26 and float(got.weights.sum()) == 512
    # the mesh driver through the selector, and the fp32 one-level tree
    # against select_distributed
    on_mesh = sel.select_tree(x, (2, 2), mesh=T.tree_mesh(T.TreeTopology((2, 2)), ["cpu"] * 4))
    np.testing.assert_array_equal(on_mesh.indices, got.indices)
    a = sel.select_tree(x, (4,), compress="none")
    b = sel.select_distributed(x, cpu_mesh(4))
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.weights, b.weights)
    with pytest.raises(ValueError, match="mode='budget' only"):
        CraigSelector(CraigConfig(mode="cover"), device="cpu").select_tree(x, (2,))


def test_select_tree_cosine_units():
    # the fp32 wire: on the int8 wire the medoids that re-weight the pool
    # are the dequantized candidates, as in the reference
    x = _pool(400, 6, seed=5)
    cs = CraigSelector(CraigConfig(fraction=0.05, metric="cosine", per_class=False),
                       device="cpu").select_tree(x, (2, 2), compress="none")
    u = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
    np.testing.assert_allclose(cs.coverage, np.min(1.0 - u @ u[cs.indices].T, axis=1).sum(),
                               rtol=1e-4)


def test_driver_error_paths():
    x = torch.as_tensor(_pool(100, 4, seed=6))
    topo = T.TreeTopology((2, 2))
    with pytest.raises(ValueError, match="not a wire mode"):
        T.tree_select_host(x, topo, 4, 8, compress="fp16")
    with pytest.raises(ValueError, match="only has 3 points"):
        T.tree_select_host(x[:3], topo, 1, 2)
    with pytest.raises(ValueError, match="exceeds the shard pool"):
        T.tree_select_host(x, topo, 30, 8)
    with pytest.raises(ValueError, match="not divisible"):
        T.tree_select_mesh(x[:99], T.tree_mesh(topo, ["cpu"] * 4), topo, 4, 8)
    with pytest.raises(ValueError, match="missing level axis"):
        T.tree_select_mesh(x, cpu_mesh(4), topo, 4, 8)
    with pytest.raises(ValueError, match="3 devices"):
        T.tree_mesh(topo, ["cpu"] * 3)
    with pytest.raises(ValueError, match="r_node=0"):
        T.tree_select_host(x, topo, 4, 8, r_node=0)
