"""Port distributed selection (``repro_torch.core.distributed``) against the
reference's (``repro.core.distributed``), on the CPU.

Both packages get the same numpy pools.  The reference runs its jnp
bodies (kernel routes 'jax'); the port its plain twins ('torch').

Tie rule (``repro_torch.parity``): a leaf round is held index for index up
to its first divergence, where both picks must be within
τ = 8·√ε₃₂·max‖x‖ of the fp64 best gain; a merge round — a weighted
greedy — the same with its point weights and τ·max γ.  Without a
divergence γ must be exactly equal.  A tree (and the two-round path, its
depth-1 case) is replayed stage by stage in both packages
(:func:`replay`), each stage held to the rule; past a divergence the two
final selections are compared by fp64 coverage L(S), within 1e-3
relative.  Within the port, the drivers must agree bit for bit.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import engines as JE
from repro.core.craig import CraigConfig as JCraigConfig
from repro.core.craig import CraigSelector as JCraigSelector
from repro.distributed import tree_select as JT
from repro.launch.mesh import compat_mesh as jcompat_mesh
from repro_torch import convert, parity
from repro_torch.core import distributed as D
from repro_torch.core import engines as E
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.distributed import tree_select as T
from repro_torch.launch.mesh import Mesh, compat_mesh, make_host_mesh, make_production_mesh
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

CPU = torch.device("cpu")
OBJECTIVE_RTOL = 1e-3

# (reference config, port config) of each round-1 engine, kernels off
ENGINES = {
    "matrix": (JE.MatrixConfig(), E.MatrixConfig()),
    "features": (JE.FeaturesConfig(gains_impl="jax", block_n=128),
                 E.FeaturesConfig(gains_impl="torch", block_n=128)),
    "device": (JE.DeviceConfig(gains_impl="jax"), E.DeviceConfig(gains_impl="torch")),
    "sparse": (JE.SparseConfig(k=16), E.SparseConfig(k=16, impl="torch")),
}


def _pool(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def cpu_mesh(shards: int) -> Mesh:
    return compat_mesh((shards,), ("data",), devices=["cpu"])


# ---------------------------------------------------------------------------
# Stage-by-stage replay of a tree in either package
# ---------------------------------------------------------------------------


def replay(pkg, x, fanouts, r_local, r_final, compress, engine, r_node=None):
    """The stages of ``tree_select_host`` run with ``pkg``'s level functions:
    a list of levels (leaves first), each a list of nodes
    ``{"x", "pw", "gidx", "idx", "w"}`` (numpy): the node's input pool,
    its point weights (None at a leaf), the inputs' global ids, the
    selected positions and their γ."""
    port = pkg == "port"
    n = x.shape[0]
    r_node = max(r_local, r_final) if r_node is None else r_node
    slices = np.array_split(np.arange(n), int(np.prod(fanouts)))

    def leaf(xs):
        if port:
            i, w = D.leaf_round(torch.as_tensor(xs), r_local, engine)
            return i.numpy(), w.numpy()
        i, w = JD.leaf_round(jnp.asarray(xs), r_local, engine)
        return np.asarray(i), np.asarray(w)

    def merge(cf, cw, budget):
        if port:
            r = D.merge_round(torch.as_tensor(cf), torch.as_tensor(cw), budget)
            return r.indices.numpy(), r.weights.numpy()
        r = JD.merge_round(jnp.asarray(cf), jnp.asarray(cw), budget)
        return np.asarray(r.indices), np.asarray(r.weights)

    def wire(f):
        if port:
            return T._through_wire(torch.as_tensor(f), compress).numpy()
        return np.asarray(JT._through_wire(jnp.asarray(f), compress))

    levels = [[]]
    for sl in slices:
        i, w = leaf(x[sl])
        levels[0].append({"x": x[sl], "pw": None, "gidx": sl, "idx": i, "w": w})
    for level, fanout in enumerate(fanouts):
        below = levels[-1]
        r_below = len(below[0]["idx"])
        budget = r_final if level == len(fanouts) - 1 else min(r_node, fanout * r_below)
        nodes = []
        for lo in range(0, len(below), fanout):
            group = below[lo:lo + fanout]
            cf = np.concatenate([wire(g["x"][g["idx"]]) for g in group])
            cw = np.concatenate([g["w"] for g in group])
            cg = np.concatenate([g["gidx"][g["idx"]] for g in group])
            i, w = merge(cf, cw, budget)
            nodes.append({"x": cf, "pw": cw, "gidx": cg, "idx": i, "w": w})
        levels.append(nodes)
    return levels


def root_of(levels):
    (root,) = levels[-1]
    return root["gidx"][root["idx"]]


def graph_first_divergence(x, k, idx_a, idx_b, tol):
    """The tie rule of a sparse leaf, whose greedy maximizes the top-k
    graph objective: fp64 gains of that objective over the reference's
    graph (its values differ from the port's by self-distance rounding)."""
    from repro.core import facility_location as jfl

    a, b = list(idx_a), list(idx_b)
    t = next((i for i in range(len(a)) if a[i] != b[i]), None)
    if t is None:
        return None
    vals, nbr = jfl.topk_graph(jnp.asarray(x), k)
    vals, nbr = np.asarray(vals, np.float64), np.asarray(nbr)
    cur = np.zeros(x.shape[0])
    for e in a[:t]:
        cur = np.maximum(cur, np.where(nbr == e, vals, -np.inf).max(axis=1))
    g = np.zeros(x.shape[0])
    np.add.at(g, nbr.ravel(), np.maximum(vals - cur[:, None], 0.0).ravel())
    g[a[:t]] = -np.inf
    best = g.max()
    assert best - g[a[t]] <= tol and best - g[b[t]] <= tol, (t, a[t], b[t], g[a[t]], g[b[t]])
    return t


def hold_stages(ref, got, *, graph_k=None):
    """Hold the port's stages to the reference's under the tie rule (a
    sparse leaf's with ``graph_k``, its graph's k).  Returns (level, node,
    position) of the first divergence, or None."""
    for level, (rn, gn) in enumerate(zip(ref, got)):
        for node, (a, b) in enumerate(zip(rn, gn)):
            np.testing.assert_array_equal(b["x"], a["x"])  # same inputs so far
            if a["pw"] is not None:
                np.testing.assert_array_equal(b["pw"], a["pw"])
            xt = torch.as_tensor(a["x"])
            tau = parity.tie_tolerance(xt)
            if a["pw"] is None and graph_k:
                t = graph_first_divergence(a["x"], graph_k, a["idx"], b["idx"], tau)
            elif a["pw"] is None:
                t = parity.first_divergence(xt, a["idx"], b["idx"], tau)
            else:
                t = parity.first_divergence(xt, a["idx"], b["idx"],
                                            tau * float(a["pw"].max()), weights=a["pw"])
            if t is not None:
                return level, node, t
            np.testing.assert_array_equal(b["w"], a["w"])
    return None


def hold_final(x, ref_sel, got_sel, diverged, r):
    """The final selections: equal γ and close coverage when no stage
    diverged, else fp64 objectives within OBJECTIVE_RTOL."""
    ri = np.asarray(ref_sel.indices, np.int64)
    gi = got_sel.indices.numpy()
    assert float(got_sel.weights.sum()) == x.shape[0]
    assert len(np.unique(gi)) == r
    xt = torch.as_tensor(x)
    if diverged is None:
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(got_sel.weights.numpy(), np.asarray(ref_sel.weights))
        np.testing.assert_allclose(float(got_sel.coverage), float(ref_sel.coverage),
                                   rtol=1e-4, atol=r * parity.tie_tolerance(xt))
    else:
        ca, cb = parity.coverage64(xt, ri), parity.coverage64(xt, gi)
        assert abs(ca - cb) <= OBJECTIVE_RTOL * max(ca, cb), (diverged, ca, cb)


# ---------------------------------------------------------------------------
# Leaf and merge rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("n,d,r", [(256, 16, 24), (700, 8, 40)])
def test_leaf_round_matches_reference(engine, n, d, r):
    x = _pool(n, d, seed=n + d)
    je, pe = ENGINES[engine]
    ji, jw = JD.leaf_round(jnp.asarray(x), r, je)
    pi, pw = D.leaf_round(torch.as_tensor(x), r, pe)
    assert pi.dtype == torch.int64 and float(pw.sum()) == n
    ref = [[{"x": x, "pw": None, "idx": np.asarray(ji), "w": np.asarray(jw)}]]
    got = [[{"x": x, "pw": None, "idx": pi.numpy(), "w": pw.numpy()}]]
    hold_stages(ref, got, graph_k=16 if engine == "sparse" else None)


@pytest.mark.parametrize("n,d,budget,seed", [(300, 16, 30, 0), (512, 16, 60, 0),
                                             (64, 4, 10, 3)])
def test_merge_round_matches_reference(n, d, budget, seed):
    rng = np.random.default_rng(seed)
    x = _pool(n, d, seed)
    w = rng.integers(1, 20, size=n).astype(np.float32)
    jr = JD.merge_round(jnp.asarray(x), jnp.asarray(w), budget)
    pr = D.merge_round(torch.as_tensor(x), torch.as_tensor(w), budget)
    assert float(pr.weights.sum()) == float(w.sum())
    ref = [[{"x": x, "pw": w, "idx": np.asarray(jr.indices), "w": np.asarray(jr.weights)}]]
    got = [[{"x": x, "pw": w, "idx": pr.indices.numpy(), "w": pr.weights.numpy()}]]
    hold_stages(ref, got)


# ---------------------------------------------------------------------------
# The two-round path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_distributed_select_matches_reference_two_round(engine):
    """The port's two rounds on an 8-entry CPU mesh against the reference's
    ``tree_select_host(fanouts=(8,), compress='none')``, which the
    reference's tests hold equal to its ``distributed_select``."""
    x = _pool(1024, 16, seed=11)
    je, pe = ENGINES[engine]
    ref_sel = JT.tree_select_host(jnp.asarray(x), JT.TreeTopology((8,)), 16, 40,
                                  local_engine=je, compress="none")
    got = D.distributed_select(torch.as_tensor(x), cpu_mesh(8), 16, 40, local_engine=pe)
    ref_st = replay("ref", x, (8,), 16, 40, "none", je)
    got_st = replay("port", x, (8,), 16, 40, "none", pe)
    np.testing.assert_array_equal(root_of(ref_st), np.asarray(ref_sel.indices))
    np.testing.assert_array_equal(root_of(got_st), got.indices.numpy())
    diverged = hold_stages(ref_st, got_st, graph_k=16 if engine == "sparse" else None)
    hold_final(x, ref_sel, got, diverged, 40)


def test_local_then_merge_shards_and_legacy_surface():
    x = torch.as_tensor(_pool(512, 8, seed=5))
    shards = list(torch.split(x, 128))
    idx, w, cov = D.local_then_merge(shards, 12, 20)
    want = D.distributed_select(x, cpu_mesh(4), 12, 20, local_engine=E.MatrixConfig())
    assert torch.equal(idx, want.indices) and torch.equal(w, want.weights)
    assert float(cov) == float(want.coverage)
    with pytest.warns(DeprecationWarning, match="local_engine='device'"):
        li, lw, _ = D.local_then_merge(shards, 12, 20, local_engine="device",
                                       device_q=1, device_stale_tol=0.7)
    assert float(lw.sum()) == 512 and len(torch.unique(li)) == 20
    with pytest.raises(TypeError, match="not both"):
        D.local_then_merge(shards, 12, 20, engine_config=E.MatrixConfig(),
                           local_engine="matrix")
    with pytest.raises(ValueError, match="shard sizes differ"):
        D.local_then_merge([x[:100], x[100:250]], 12, 20)
    with pytest.raises(TypeError, match="unexpected kwargs"):
        D.distributed_select(x, cpu_mesh(4), 12, 20, local_engine="sparse", bogus=1)


def test_distributed_select_cosine_units_and_two_axis_mesh():
    x = _pool(256, 8, seed=6)
    mesh = compat_mesh((2, 4), ("model", "data"), devices=["cpu"])
    assert mesh.shape == {"model": 2, "data": 4} and mesh.axis_devices("data") == [CPU] * 4
    sel = CraigSelector(CraigConfig(fraction=0.1, metric="cosine", per_class=False),
                        device="cpu")
    cs = sel.select_distributed(x, mesh)
    u = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
    cos = 1.0 - u @ u[cs.indices].T
    np.testing.assert_allclose(cs.coverage, np.min(cos, axis=1).sum(), rtol=1e-4)
    assert float(cs.weights.sum()) == 256 and cs.size == 26


# ---------------------------------------------------------------------------
# Audits, engine resolution, provenance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(10, 4, 0, 5), (10, 4, 12, 5), (10, 4, 2, 9),
                                  (100, 2, 3, 7)])
def test_candidate_count_audit_messages_equal_the_reference(args):
    with pytest.raises(ValueError) as jerr:
        JD.check_candidate_counts(*args, where="w")
    with pytest.raises(ValueError) as err:
        D.check_candidate_counts(*args, where="w")
    assert str(err.value) == str(jerr.value)
    JD.check_candidate_counts(100, 4, 10, 40)
    D.check_candidate_counts(100, 4, 10, 40)


def test_even_shard_audit_message_equals_the_reference():
    with pytest.raises(ValueError) as jerr:
        JD.check_even_shards(1001, 8, where="distributed_select")
    with pytest.raises(ValueError) as err:
        D.check_even_shards(1001, 8, where="distributed_select")
    assert str(err.value) == str(jerr.value).replace("repro.", "repro_torch.")
    with pytest.raises(ValueError, match="not divisible"):
        D.distributed_select(torch.zeros(1001, 4), cpu_mesh(8), 4, 8)
    with pytest.raises(ValueError, match="exceeds the shard pool"):
        D.distributed_select(torch.zeros(64, 4), cpu_mesh(8), 9, 8)


RESOLVE_CASES = {
    "auto-small": ("auto", {}, 1_000),
    "auto-features": ("auto", {}, 50_000),
    "auto-sparse": ("auto", {}, 300_000),
    "legacy-sparse": ("sparse", {"topk_k": 32}, 1_000),
    "legacy-device": ("device", {"device_q": 4, "device_stale_tol": 0.9}, 1_000),
    "typed-features": ("features", {}, 1_000),
    "lazy-falls-back": ("lazy", {}, 1_000),
    "stochastic-falls-back": ("stochastic", {}, 50_000),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_round1_provenance_equals_the_reference(case):
    engine, knobs, n_local = RESOLVE_CASES[case]
    if case.startswith("typed"):
        jarg, parg = JE.FeaturesConfig(gains_impl="pallas"), E.FeaturesConfig()
    elif engine in ("lazy", "stochastic"):
        jarg = JE.get_engine(engine).config_cls()
        parg = E.get_engine(engine).config_cls()
    else:
        jarg = parg = engine
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = JD.resolve_round1_config(jarg, dict(knobs), n_local)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = D.resolve_round1_config(parg, dict(knobs), n_local, device=CPU)
    assert got == convert.engine_config_from_reference(want.to_dict())
    assert [type(w.message) for w in pw if w.category is not UserWarning or
            "pinned" not in str(w.message)] == [
        type(w.message) for w in jw if "pinned" not in str(w.message)]
    # idempotent on a resolved config
    assert D.resolve_round1_config(got, {}, n_local, device=CPU) == got


def test_round1_routes_resolve_on_the_shard_device():
    assert D.normalize_round1_config(E.DeviceConfig(), torch.device("cuda")).gains_impl == "cuda"
    assert D.normalize_round1_config(E.SparseConfig(), CPU).impl == "torch"
    assert D.normalize_round1_config(E.FeaturesConfig(gains_impl="torch"),
                                     torch.device("cuda")).gains_impl == "torch"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        D.normalize_round1_config(E.DeviceConfig(gains_impl="cuda"), CPU)


def test_select_distributed_provenance_and_selection_on_one_shard():
    """The reference on a 1-device mesh (in process) against the port on a
    1-entry mesh: the same selection and the same provenance."""
    x = _pool(200, 8, seed=7)
    jm = jcompat_mesh((1,), ("data",))
    want = JCraigSelector(JCraigConfig(fraction=0.05, per_class=False)
                          ).select_distributed(jnp.asarray(x), jm)
    got = CraigSelector(CraigConfig(fraction=0.05, per_class=False),
                        device="cpu").select_distributed(x, cpu_mesh(1))
    assert got.engine == convert.engine_config_from_reference(want.engine).to_dict()
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.weights, want.weights)
    with pytest.raises(ValueError, match="mode='budget' only"):
        CraigSelector(CraigConfig(mode="cover"), device="cpu").select_distributed(
            x, cpu_mesh(1))


def test_meshes():
    m = compat_mesh((2, 2), ("a", "b"), devices=["cpu", "cpu"])
    assert m.size == 4 and m.flat_devices() == [CPU] * 4
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_production_mesh()  # a DeviceMesh over the process group: none here
    with pytest.raises(ValueError, match="no axis"):
        m.axis_devices("c")
    with pytest.raises(ValueError, match="do not tile"):
        compat_mesh((3,), ("a",), devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            compat_mesh((4,), ("data",))  # the default devices are the cards


# ---------------------------------------------------------------------------
# The data-parallel extract
# ---------------------------------------------------------------------------


def test_scan_extract_and_mesh_extract(monkeypatch):
    import repro.models.model as jmodel
    from repro.core.extract import make_scan_extract as jmake_scan_extract
    from repro.data.synthetic import TokenStream as JTokenStream
    from repro.models.config import ModelConfig as JModelConfig
    from repro.train.train_step import make_select_step as jmake_select_step
    from repro_torch.core.extract import ProxyExtractor, make_scan_extract
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import model as tmodel
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.train_step import make_select_step

    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    small = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
                 n_kv_heads=2, d_ff=64, vocab_size=128, logit_chunk=16)
    jcfg, cfg = JModelConfig(**small), ModelConfig(**small)
    jp = ref_init(jcfg, 1)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jds = JTokenStream(n_docs=40, seq_len=16, vocab_size=128)
    ds = TokenStream(n_docs=40, seq_len=16, vocab_size=128)
    # the one scan body against the reference's, on the same (M, B) batches
    b = ds.batch(np.arange(24))
    mb = {k: np.asarray(v).reshape((6, 4) + np.shape(v)[1:]) for k, v in b.items()}
    want = np.asarray(jax.jit(jmake_scan_extract(jmake_select_step(jcfg, "einsum")))(
        jp, {k: jnp.asarray(v) for k, v in mb.items()}))
    got = make_scan_extract(make_select_step(cfg, "auto"))(
        tp, {k: torch.as_tensor(v) for k, v in mb.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the mesh extract: 4 shards, a pool whose batch count pads to them
    pool = np.arange(0, 40, 2)[:19]  # 5 batches of 4 → a plan of 8
    single = ProxyExtractor(make_select_step(cfg, "auto"), ds, 4, megabatch=3)
    meshed = ProxyExtractor(make_select_step(cfg, "auto"), ds, 4, megabatch=3,
                            mesh=cpu_mesh(4))
    assert meshed._plan(19) == [(0, 4), (4, 4)]
    f1, f4 = single.extract(tp, pool), meshed.extract(tp, pool)
    assert f4.shape == (19, 32) and torch.equal(f4, f1)
    jx = __import__("repro.core.extract", fromlist=["ProxyExtractor"]).ProxyExtractor(
        jmake_select_step(jcfg, "einsum"), jds, 4, megabatch=3)
    np.testing.assert_allclose(f4.numpy(), np.asarray(jx.extract(jp, pool)),
                               rtol=1e-4, atol=1e-5)
