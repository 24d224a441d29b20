"""Tree selection over a ``torch.distributed`` group, one program a rank
(``distributed/tree_select.py::tree_select_mesh`` over
``launch/tree.py::make_tree_mesh``, and ``core/distributed.py``'s two
rounds over a one-axis ``DeviceMesh``), over gloo on the CPU.

One spawn of four ranks for the module (``tests/torch_mesh_worker.py``,
case ``tree_mesh``) on the reference's mesh-test size, a seeded clustered
512 × 16 pool with r_local 6 and r_final 10: fan-outs (2, 2) and
(2, 2, 2) on the four ranks, (2, 2) and (4, 2) on ranks 0–1 in a group of
two, (4, 1) on rank 0 alone, each on the int8 and the fp32 wire.  Every
rank's selection must be the same, equal the port's ``tree_select_host``
bit for bit, and call the collectives ``collectives_plan`` counts.

Against the reference's ``tree_select_host``, called here, the tree is
replayed stage by stage in both packages and held to the tie rule
(``tests/test_torch_distributed.py``).  Without a divergence indices and γ
are equal and coverage within rtol 1e-4 + r·τ: the port's self-distances
round differently from the reference's (``ROADMAP.md`` queue 3), which
moves coverage by up to 1.6e-5 relative on this pool with every index
equal.  Fan-outs (2, 2) diverge at an exact tie: in the first level-1
merge two candidates, one from each leaf, are alone in a cluster with γ
18 each, so their gains are equal in exact arithmetic and each package's
rounding picks one (the reference picks differently on its two wires).
Past such a tie the trees differ by more than the suite's 1e-3 objective
bound (0.38% here, r = 10), so every stage of the port's tree is then
held on its own inputs: the reference's leaf and merge rounds run on the
port's stage inputs and the tie rule holds each, and the final γ and
coverage are held to an fp64 assignment of the pool to the port's
medoids.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from repro.core import distributed as JD
from repro.distributed import tree_select as JT
from repro_torch import parity
from repro_torch.core import distributed as D
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.distributed import tree_select as T
from test_torch_distributed import ENGINES, cpu_mesh, hold_final, hold_stages, replay, root_of
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

CASES = [(fo, world, c) for fo, world in W.TREE_CASES for c in ("int8", "none")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tree_mesh"))
    W.launch("tree_mesh", out)
    return [torch.load(f"{out}/tree_mesh.{r}.pt", weights_only=False) for r in range(4)]


@pytest.fixture(scope="module")
def pool():
    return W.tree_pool()


def _hold_to_reference(x, fanouts, compress, got):
    ref_sel = JT.tree_select_host(jnp.asarray(x), JT.TreeTopology(fanouts), W.TREE_R_LOCAL,
                                  W.TREE_R_FINAL, compress=compress)
    ref_st = replay("ref", x, fanouts, W.TREE_R_LOCAL, W.TREE_R_FINAL, compress,
                    ENGINES["matrix"][0])
    got_st = replay("port", x, fanouts, W.TREE_R_LOCAL, W.TREE_R_FINAL, compress,
                    ENGINES["matrix"][1])
    np.testing.assert_array_equal(root_of(ref_st), np.asarray(ref_sel.indices))
    np.testing.assert_array_equal(root_of(got_st), got.indices.numpy())
    diverged = hold_stages(ref_st, got_st)
    if diverged is None:
        hold_final(x, ref_sel, got, None, W.TREE_R_FINAL)
    else:
        _hold_each_stage(x, got_st, got)
    return diverged


def _hold_each_stage(x, got_st, got):
    """Every stage of the port's tree on its own inputs: the reference's
    leaf round on each leaf's rows and merge round on each merge node's
    union (its weights, its budget), each held to the tie rule; then γ
    and coverage against an fp64 assignment of the pool to the medoids."""
    for nodes in got_st:
        for node in nodes:
            if node["pw"] is None:
                i, w = JD.leaf_round(jnp.asarray(node["x"]), W.TREE_R_LOCAL,
                                     ENGINES["matrix"][0])
            else:
                r = JD.merge_round(jnp.asarray(node["x"]), jnp.asarray(node["pw"]),
                                   len(node["idx"]))
                i, w = r.indices, r.weights
            hold_stages([[{**node, "idx": np.asarray(i), "w": np.asarray(w)}]], [[node]])
    xt = torch.from_numpy(x)
    tau = parity.tie_tolerance(xt)
    d = torch.cdist(xt.double(), xt.double()[got.indices])
    two = torch.topk(d, 2, largest=False).values
    near = int((two[:, 1] - two[:, 0] <= tau).sum())  # rows either medoid may take
    want = torch.bincount(d.argmin(1), minlength=W.TREE_R_FINAL).double()
    assert float((got.weights.double() - want).abs().sum()) <= 2 * near
    np.testing.assert_allclose(float(got.coverage), parity.coverage64(xt, got.indices.numpy()),
                               rtol=1e-4, atol=W.TREE_R_FINAL * tau)


@pytest.mark.parametrize("fanouts,world,compress", CASES,
                         ids=[f"{'x'.join(map(str, f))}-on-{w}-{c}" for f, w, c in CASES])
def test_tree_over_ranks_equals_the_host_driver_and_the_reference(ranks, pool, fanouts,
                                                                  world, compress):
    got = [ranks[r][(fanouts, world, compress)] for r in range(world)]
    for other in got[1:]:  # every rank returns the same selection
        assert all(torch.equal(a, b) for a, b in zip(other[:3], got[0][:3]))
    idx, w, cov, calls = got[0]
    topo = T.TreeTopology(fanouts)
    host = T.tree_select_host(pool, topo, W.TREE_R_LOCAL, W.TREE_R_FINAL, compress=compress)
    assert torch.equal(idx, host.indices) and torch.equal(w, host.weights)
    assert torch.equal(cov, host.coverage)
    assert float(w.sum()) == W.TREE_N
    _, axes = T.split_levels(fanouts, world)
    assert all(r[(fanouts, world, compress)][3] == T.collectives_plan(len(axes), compress)
               for r in ranks[:world])
    _hold_to_reference(pool, fanouts, compress,
                       types.SimpleNamespace(indices=idx, weights=w, coverage=cov))


@pytest.mark.parametrize("fanouts,world", W.TREE_CASES,
                         ids=[f"{'x'.join(map(str, f))}-on-{w}" for f, w in W.TREE_CASES])
def test_partials_gather_in_leaf_order(ranks, fanouts, world):
    """The re-weighting's gather (``core.distributed.leaf_rows``) of each
    rank's leaf ids: every leaf in leaf order on every rank, which the
    coverage sum relies on (a 4-term fp32 sum in another order may round
    the same, so the selections alone cannot show it)."""
    n_leaves = T.TreeTopology(fanouts).n_leaves
    for r in ranks[:world]:
        assert r[(fanouts, world, "leaf_rows")].tolist() == list(range(n_leaves))


def test_two_rounds_over_four_ranks(ranks, pool):
    """``distributed_select`` over a 4-rank ``DeviceMesh``: bit for bit the
    in-process two rounds on a 4-shard CPU ``Mesh``, and the reference's
    one-level fp32 tree under the tie rule; ``select_distributed`` over
    the same mesh equals it over the in-process one."""
    got = [r["two_rounds"] for r in ranks]
    want = D.distributed_select(torch.from_numpy(pool), cpu_mesh(W.TREE_SHARDS),
                                W.TREE_R_LOCAL, W.TREE_R_FINAL)
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))
    _hold_to_reference(pool, (W.TREE_SHARDS,), "none", want)
    sel = CraigSelector(CraigConfig(fraction=0.05, per_class=False), device="cpu")
    here = sel.select_distributed(pool, cpu_mesh(W.TREE_SHARDS))
    for r in ranks:
        idx, w, cov, engine = r["select_distributed"]
        np.testing.assert_array_equal(idx, here.indices)
        np.testing.assert_array_equal(w, here.weights)
        assert cov == here.coverage and engine == here.engine


def test_errors_over_ranks(ranks):
    """A ragged pool fails with the reference's "not divisible" audit on
    every rank, and fan-outs that do not fit the group name both."""
    for r in ranks:
        assert "not divisible" in r["ragged"] and "n=509" in r["ragged"]
        assert "(4, 2)" in r["misfit"] and "4 ranks" in r["misfit"]


@pytest.mark.parametrize("fanouts,world,split", [
    ((2, 2), 4, (0, ("lvl1", "lvl0"))),
    ((2, 2), 2, (1, ("lvl1",))),
    ((4, 2), 2, (1, ("lvl1",))),
    ((2, 2, 2), 4, (1, ("lvl2", "lvl1"))),
    ((4, 1), 1, (1, ("lvl1",))),
    ((8, 4, 1), 1, (2, ("lvl2",))),
    ((2, 1, 1), 1, (1, ("lvl2", "lvl1"))),
    ((4, 2), 8, (0, ("lvl1", "lvl0"))),
    ((3, 2, 2), 4, (1, ("lvl2", "lvl1"))),
])
def test_split_levels(fanouts, world, split):
    assert T.split_levels(fanouts, world) == split


@pytest.mark.parametrize("fanouts,world,match", [
    ((4, 2), 4, r"\(4, 2\).* 4 ranks"),
    ((2, 2), 3, r"\(2, 2\).* 3 ranks"),
    ((2, 2), 16, r"\(2, 2\).* 16 ranks"),
    ((4, 2), 1, r"end them with a fan-out of 1"),
])
def test_split_levels_rejects_a_misfit(fanouts, world, match):
    with pytest.raises(ValueError, match=match):
        T.split_levels(fanouts, world)


def test_collectives_plan():
    assert [T.collectives_plan(n, "int8") for n in (1, 2, 3)] == [5, 10, 15]
    assert [T.collectives_plan(n, "none") for n in (1, 2, 3)] == [4, 8, 12]
    with pytest.raises(ValueError, match="not a wire mode"):
        T.collectives_plan(1, "fp16")
