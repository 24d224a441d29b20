"""Sparse selection in the port (repro_torch) against the JAX reference.

On the CPU the port's ``ops.topk_sim`` and ``ops.pairwise_l2`` run their
plain twins (``chip_smoke.py`` holds the CUDA kernels to those twins on
the card); the reference runs its Pallas kernels in interpret mode and its
jnp ``topk_graph`` scan.  Both packages get the same numpy inputs.

Tolerances.  Similarities and distances: atol τ₄ = 4·√ε₃₂·max‖x‖, the
self-distance rounding of √(‖x‖² + ‖y‖² − 2·x·y), which each framework's
dot order leaves at ~√ε₃₂·‖x‖ instead of 0 (ROADMAP queue 3); other pairs
are far inside it.  Indices follow the tie rule of ``repro_torch.parity``:
equal wherever the fp64 similarities of the two columns differ by more
than τ₄, either order otherwise.  Selections: equal indices and γ, or —
after a near-tie flip in the graph — fp64 objectives within 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as JE
from repro.core.craig import CraigConfig as JCraigConfig
from repro.core.craig import CraigSelector as JCraigSelector
from repro.core.engines import sparse as JS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import parity
from repro_torch.convert import engine_config_from_reference
from repro_torch.core import engines as E
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.core.engines import sparse as S
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pairwise_l2 as kpw
from repro_torch.kernels import topk_sim as ktk
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

EPS32 = float(np.finfo(np.float32).eps)


def _feats(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _clustered(n, d, n_clusters, seed, spread=10.0, sigma=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * spread
    labels = np.arange(n) % n_clusters
    x = centers[labels] + sigma * rng.normal(size=(n, d))
    return x.astype(np.float32), labels


def _tau(*arrays):
    return 4.0 * np.sqrt(EPS32) * max(float(np.linalg.norm(a, axis=1).max()) for a in arrays)


def _d_max(x):
    return np.float32(2.0 * np.sqrt((x.astype(np.float32) ** 2).sum(1).max()) + 1e-6)


def assert_same_graph(x, d_max, got, want, tol):
    """Hold (vals, idx) ``got`` to ``want`` under the tie rule."""
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape and gi.dtype == np.int32
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=tol)
    x64 = x.astype(np.float64)
    rows, cols = np.nonzero(gi != wi)
    for i, t in zip(rows, cols):
        a, b = gi[i, t], wi[i, t]
        sa = d_max - np.linalg.norm(x64[i] - x64[a])
        sb = d_max - np.linalg.norm(x64[i] - x64[b])
        assert abs(sa - sb) <= tol, (i, t, a, b, sa, sb, tol)
    # every row's best neighbour is itself
    np.testing.assert_array_equal(gi[:, 0], np.arange(len(x)))


# k past 128 (the CUDA kernel's register lists) and k = n; the reference's
# Pallas kernel in interpret mode takes minutes there, so those cases hold
# the twin to the reference's jnp scan and dense oracle.
@pytest.mark.parametrize("n,d,k", [(37, 5, 7), (130, 12, 23), (300, 33, 64), (300, 12, 256),
                                   (160, 8, 160)])
def test_topk_sim_twin_matches_reference(n, d, k):
    x = _feats(n, d, seed=n + d)
    d_max = _d_max(x)
    tol = _tau(x)
    got = ops.topk_sim(torch.as_tensor(x), k, float(d_max), block_m=64)
    if k <= 128:
        assert_same_graph(x, d_max, got, jops.topk_sim(jnp.asarray(x), k, d_max), tol)
    assert_same_graph(
        x, d_max, got,
        JS.topk_graph(jnp.asarray(x), k, d_max=d_max, block_m=64, impl="jax"), tol,
    )
    assert_same_graph(x, d_max, got, jref.topk_sim_ref(jnp.asarray(x), k, d_max), tol)
    # the port's own dense oracle, and the default offset
    assert_same_graph(x, d_max, got, ref.topk_sim_ref(torch.as_tensor(x), k, float(d_max)), tol)
    assert_same_graph(x, d_max, got, S.topk_graph(torch.as_tensor(x), k, impl="torch"), tol)


@pytest.mark.parametrize("k", [129, 400])
def test_topk_graph_past_k_128_matches_reference(k):
    """The sparse engine's graph at k > 128 (up to k = n) on the CPU: the
    reference's graph under the tie rule."""
    x, _ = _clustered(400, 6, 8, seed=13, spread=3.0, sigma=1.0)
    d_max = _d_max(x)
    got = S.topk_graph(torch.as_tensor(x), k, d_max=float(d_max))
    assert got[0].shape == (400, k)
    want = JS.topk_graph(jnp.asarray(x), k, d_max=d_max, impl="jax")
    assert_same_graph(x, d_max, got, want, _tau(x))
    assert_same_graph(x, d_max, got, jref.topk_sim_ref(jnp.asarray(x), k, d_max), _tau(x))
    assert np.all(np.diff(got[0].numpy(), axis=1) <= 0)  # descending


def test_topk_sim_twin_block_width_does_not_change_the_graph():
    # the tile width changes the product's shape, hence the self-distance
    # rounding: values within τ₄, indices by the tie rule
    xn = _feats(200, 6, seed=4)
    x = torch.as_tensor(xn)
    sq = (x * x).sum(1)
    d_max = 2.0 * torch.sqrt(sq.max()) + 1e-6
    want = ktk.topk_sim_torch(x, sq, d_max, 17, block_m=200)
    for bm in (1, 7, 64):
        got = ktk.topk_sim_torch(x, sq, d_max, 17, block_m=bm)
        assert_same_graph(xn, float(d_max), got, want, _tau(xn))


def test_topk_sim_keeps_the_lower_column_on_exact_ties():
    # rows 0, 3 and 5 are the same point: exact ties in every row's list
    x = _feats(8, 3, seed=1)
    x[3] = x[0]
    x[5] = x[0]
    d_max = _d_max(x)
    _, gi = ops.topk_sim(torch.as_tensor(x), 4, float(d_max), block_m=2)
    _, wi = jref.topk_sim_ref(jnp.asarray(x), 4, d_max)
    np.testing.assert_array_equal(gi.numpy()[[0, 3, 5], :3], np.asarray(wi)[[0, 3, 5], :3])
    np.testing.assert_array_equal(gi.numpy()[0, :3], [0, 3, 5])


@pytest.mark.parametrize("dups,k,block_m", [
    ((0, 3, 5), 2, 2), ((0, 3, 5, 6, 9, 11), 3, 16), ((0, 3, 5, 6, 9, 11), 4, 64),
    ((2, 5, 7, 11, 13), 3, 4),
])
def test_topk_sim_twin_keeps_the_lower_column_at_the_kth_place(dups, k, block_m):
    # more copies of one point than k: the tie falls on the k-th place of
    # each copy's row, where lax.top_k keeps the lowest columns
    x = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
    x[list(dups)] = x[dups[0]]
    d_max = _d_max(x)
    gv, gi = ops.topk_sim(torch.as_tensor(x), k, float(d_max), block_m=block_m)
    for wv, wi in (jref.topk_sim_ref(jnp.asarray(x), k, d_max),
                   JS.topk_graph(jnp.asarray(x), k, d_max=d_max, impl="jax")):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=_tau(x))
    np.testing.assert_array_equal(gi.numpy()[list(dups)], np.tile(dups[:k], (len(dups), 1)))


@pytest.mark.parametrize("n,m,d,self_pairs", [
    (37, 5, 3, False), (130, 129, 22, True), (300, 77, 33, False),
])
def test_pairwise_l2_matches_reference(n, m, d, self_pairs):
    x = _feats(n, d, seed=n + m)
    y = x[:m] if self_pairs else _feats(m, d, seed=n * m)
    tol = _tau(x, y)
    got = ops.pairwise_l2(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert got.shape == (n, m) and got.dtype == np.float32
    for want in (jops.pairwise_l2(jnp.asarray(x), jnp.asarray(y)),
                 jref.pairwise_l2_ref(jnp.asarray(x), jnp.asarray(y)),
                 ref.pairwise_l2_ref(torch.as_tensor(x), torch.as_tensor(y))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=tol)


def test_blocked_assignment_matches_reference():
    x = _feats(500, 7, seed=2)
    sel = np.random.default_rng(3).choice(500, 40, replace=False)
    assign, mind = S._blocked_assignment(torch.as_tensor(x), sel, block=128)
    jassign, jmind = JS._blocked_assignment(x, sel, block=128)
    tol = _tau(x)
    np.testing.assert_allclose(mind, jmind, rtol=1e-5, atol=tol)
    d64 = np.linalg.norm(x.astype(np.float64)[:, None, :] - x[sel].astype(np.float64)[None],
                         axis=2)
    for i in np.nonzero(assign != jassign)[0]:
        assert abs(d64[i, assign[i]] - d64[i, jassign[i]]) <= tol, i
    assert assign.dtype == np.int64 and mind.dtype == np.float64
    # the default block (one ~1 GB distance matrix) gives the same
    a2, m2 = S._blocked_assignment(torch.as_tensor(x), sel)
    np.testing.assert_array_equal(a2, assign)
    np.testing.assert_array_equal(m2, mind)


def _graph(n=240, d=8, k=24, seed=5):
    x, _ = _clustered(n, d, 8, seed=seed)
    vals, idx = JS.topk_graph(jnp.asarray(x), k, impl="jax")
    return x, np.array(vals), np.array(idx)


@pytest.mark.parametrize("budget", [1, 9, 40])
def test_host_and_torch_greedy_agree_on_one_graph(budget):
    """The same numpy graph through both port greedies and both reference
    greedies: indices and γ equal."""
    _, vals, idx = _graph()
    host = S.sparse_greedy_fl(vals, idx, budget)
    loop = S.greedy_fl_topk(torch.as_tensor(vals), torch.as_tensor(idx), budget)
    jhost = JS.sparse_greedy_fl(vals, idx, budget)
    jloop = JS.greedy_fl_topk(jnp.asarray(vals), jnp.asarray(idx), budget)
    for other in (loop, jhost, jloop):
        np.testing.assert_array_equal(host.indices.numpy(), np.asarray(other.indices))
        np.testing.assert_array_equal(host.weights.numpy(), np.asarray(other.weights))
        np.testing.assert_allclose(host.gains.numpy(), np.asarray(other.gains), rtol=1e-5)
        np.testing.assert_allclose(float(host.coverage), float(other.coverage), rtol=1e-5)
    assert float(host.weights.sum()) == 240.0


def test_host_greedy_with_features_and_warm_start_matches_reference():
    x, vals, idx = _graph()
    prefix = np.array([7, 100, 3])
    got = S.sparse_greedy_fl(vals, idx, 20, feats=torch.as_tensor(x), init_selected=prefix)
    want = JS.sparse_greedy_fl(vals, idx, 20, feats=x, init_selected=prefix)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.indices.numpy()[:3], prefix)
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_allclose(float(got.coverage), float(want.coverage), rtol=1e-5,
                               atol=20 * _tau(x))
    sq = S.sparse_greedy_fl(vals, idx, 20, feats=torch.as_tensor(x), squared_coverage=True)
    jsq = JS.sparse_greedy_fl(vals, idx, 20, feats=x, squared_coverage=True)
    np.testing.assert_allclose(float(sq.coverage), float(jsq.coverage), rtol=1e-4)
    with pytest.raises(ValueError, match="squared_coverage"):
        S.sparse_greedy_fl(vals, idx, 5, squared_coverage=True)


def _same_selection(x, labels, got, want):
    """Equal indices and γ, or fp64 objectives within 1e-3 per class."""
    if np.array_equal(got.indices, want.indices):
        np.testing.assert_array_equal(got.weights, want.weights)
        return
    for c in np.unique(labels):
        pool = np.nonzero(labels == c)[0]
        xc = torch.as_tensor(x[pool])
        a = np.searchsorted(pool, got.indices[np.isin(got.indices, pool)])
        b = np.searchsorted(pool, want.indices[np.isin(want.indices, pool)])
        ca, cb = parity.coverage64(xc, a), parity.coverage64(xc, b)
        assert abs(ca - cb) <= 1e-3 * max(ca, cb), (c, ca, cb)


@pytest.mark.parametrize("per_class", [False, True])
def test_craig_selector_sparse_engine_matches_reference(per_class):
    x, labels = _clustered(2000, 8, 16, seed=9, spread=4.0, sigma=1.0)
    y = (labels % 3).astype(np.int32)
    got = CraigSelector(
        CraigConfig(fraction=0.05, engine=E.SparseConfig(k=32), per_class=per_class),
        device="cpu",
    ).select(x, y)
    want = JCraigSelector(
        JCraigConfig(fraction=0.05, engine=JE.SparseConfig(k=32), per_class=per_class)
    ).select(x, y)
    assert got.size == want.size == 100
    assert float(got.weights.sum()) == pytest.approx(2000.0)
    assert got.engine == {"name": "sparse", "k": 32, "impl": "auto", "block_m": 2048}
    _same_selection(x, y if per_class else np.zeros(2000, int), got, want)
    np.testing.assert_allclose(got.coverage, want.coverage, rtol=1e-3)


def test_sparse_engine_cosine_coverage_matches_reference():
    x, _ = _clustered(400, 6, 8, seed=11, spread=3.0, sigma=1.0)
    got = E.SparseEngine(E.SparseConfig(k=16)).select(torch.as_tensor(x), 12, metric="cosine")
    want = JE.make_engine(JE.SparseConfig(k=16)).select(jnp.asarray(x), 12, metric="cosine")
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(float(got.coverage), float(want.coverage), rtol=1e-4)


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_auto_engine_config_goes_sparse_past_the_threshold(backend):
    # the table only: nothing runs at this size
    assert E.auto_engine_config(200_001, backend=backend) == E.SparseConfig()
    assert E.auto_engine_config(200_000, backend=backend).name != "sparse"
    jb = {"cuda": "tpu", "cpu": "cpu"}[backend]
    assert JE.auto_engine_config(200_001, backend=jb).name == "sparse"


def test_sparse_config_from_reference():
    d = JE.SparseConfig(k=16, impl="pallas", block_m=512).to_dict()
    assert engine_config_from_reference(d) == E.SparseConfig(k=16, impl="cuda", block_m=512)
    d = JE.SparseConfig().to_dict()
    assert engine_config_from_reference(d) == E.SparseConfig(impl="torch")
    assert E.EngineConfig.from_dict(E.SparseConfig(k=8).to_dict()) == E.SparseConfig(k=8)
    assert E.parse_engine_spec("sparse:k=16") == E.SparseConfig(k=16)


def test_sparse_kernels_refuse_cpu_tensors():
    x = torch.randn(9, 3)
    sq = (x * x).sum(1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.topk_sim(x, 4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ktk.topk_sim_cuda(x, sq, torch.tensor(1.0), 4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.pairwise_l2(x, x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kpw.pairwise_l2_cuda(x, x, sq, sq)
    with pytest.raises(ValueError, match=r"k=10 outside"):
        ops.topk_sim(x, 10)
    assert ops.LAUNCHES["topk_sim"] == ops.LAUNCHES["pairwise_l2"] == 0
