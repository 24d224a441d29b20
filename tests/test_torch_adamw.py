"""AdamW's step over a whole parameter dict on the CPU: the plain loop
(``repro_torch.optim.optimizers.adamw_loop``) against the JAX reference,
the kernels' chunk list (``repro_torch.kernels.adamw``), and the dispatch
that keeps CPU leaves away from the CUDA library.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
them against the plain loop there (``check_adamw``).

Tolerances of the loop against the reference, four steps on the same
params and grads (the same fp32 formulas, one op at a time against XLA's
fusion): rtol 1e-6 on everything; atol 4·ε₃₂ · the largest |moment| of any
leaf on m and v (b·m + (1 − b)·g rounds once in the fusion, twice in the
loop: a few ulps of the larger term, which cancellation in m can leave far
above a one-element leaf's own m); atol 1e-6 on p (a step is lr · m̂/√v̂,
and where m nearly cancels those few ulps of m are a relative error of the
step; 4.8e-7 is the largest seen over four seeds at lr ≤ 0.05).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.kernels import _build
from repro_torch.kernels import adamw as kadam
from repro_torch.optim import optimizers as topt
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

EPS32 = float(np.finfo(np.float32).eps)
RAGGED = {"one": (1,), "three": (3,), "chunked": (4097,), "empty": (0,), "matrix": (5, 7)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("clip", ["engaged", "idle", None])
def test_plain_loop_matches_reference(clip, weight_decay):
    """Four steps on ragged leaves: the clip cutting every step (grads with
    a norm of ~100 against 1.0), set but never cutting (norm ~1e-3), off."""
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in RAGGED.items()}
    grad_scale = {"engaged": 30.0, "idle": 1e-4, None: 3.0}[clip]
    limit = None if clip is None else 1.0
    sched_j, sched_t = jopt.k_inverse(0.05, 0.5), topt.k_inverse(0.05, 0.5)
    jo = jopt.adamw(sched_j, weight_decay=weight_decay, clip=limit)
    to = topt.adamw(sched_t, weight_decay=weight_decay, clip=limit)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    launches = dict(kadam.LAUNCHES)
    for step in range(4):
        grads = {k: (grad_scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in RAGGED.items()}
        norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values())))
        assert clip is None or (norm > limit) == (clip == "engaged")
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        tp, ts = to.update({k: torch.as_tensor(v) for k, v in grads.items()}, ts, tp)
        assert ts.step == int(js.step) == step + 1
        for mom in ("m", "v"):
            scale = max(float(np.abs(np.asarray(t)).max(initial=0.0))
                        for t in js.inner[mom].values())
            for k in params:
                np.testing.assert_allclose(ts.inner[mom][k].numpy(),
                                           np.asarray(js.inner[mom][k]), rtol=1e-6,
                                           atol=4 * EPS32 * scale)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    assert kadam.LAUNCHES == launches


@pytest.mark.parametrize("sizes, chunk", [
    ((1, 3, 4097, 0, 35), 16),
    ((0, 0), 8),
    ((65_536, 65_537, 131_071, 1), kadam.CHUNK),
    ((7,), 1),
])
def test_chunk_list_covers_every_element_once_in_leaf_order(sizes, chunk):
    rows = kadam.chunk_list(sizes, chunk)
    assert rows.dtype == np.int64 and rows.shape == (sum(-(-n // chunk) for n in sizes), 3)
    assert (np.diff(rows[:, 0]) >= 0).all()  # leaf order
    for leaf, n in enumerate(sizes):
        mine = rows[rows[:, 0] == leaf]
        assert ((mine[:, 2] - mine[:, 1] > 0) & (mine[:, 2] - mine[:, 1] <= chunk)).all()
        assert (mine[:, 1] % chunk == 0).all()  # a chunk start keeps 16-byte alignment
        covered = np.zeros(n, np.int64)
        for _, start, stop in mine:
            covered[start:stop] += 1
        assert (covered == 1).all()  # every element once, the tail included


@pytest.mark.parametrize("n, max_leaves", [(0, 4), (1, 4), (4, 4), (9, 4), (91, 512)])
def test_leaf_runs_split_the_leaves_into_launches(n, max_leaves):
    runs = kadam.leaf_runs(n, max_leaves)
    assert len(runs) == -(-n // max_leaves)
    assert [i for lo, hi in runs for i in range(lo, hi)] == list(range(n))
    assert all(0 < hi - lo <= max_leaves for lo, hi in runs)


def test_cpu_leaves_take_the_loop_and_never_touch_the_library(monkeypatch):
    def no_library(name):
        raise AssertionError(f"the CUDA library {name!r} was asked for CPU leaves")

    monkeypatch.setattr(_build, "library", no_library)
    launches = dict(kadam.LAUNCHES)
    opt = topt.adamw(topt.constant(1e-2))
    params = {k: torch.randn(s) for k, s in RAGGED.items()}
    state = opt.init(params)
    before = {k: p.clone() for k, p in params.items()}
    for _ in range(2):
        params, state = opt.update({k: 5.0 * torch.randn(s) for k, s in RAGGED.items()},
                                   state, params)
    assert all(not torch.equal(params[k], before[k]) for k in params if params[k].numel())
    assert kadam.LAUNCHES == launches


def test_the_kernel_path_refuses_leaves_off_the_card():
    p = {"w": torch.zeros(4)}
    hyper = dict(lr=0.1, b1=0.9, b2=0.999, bc1=0.1, bc2=0.001, eps=1e-8, weight_decay=0.0,
                 clip=1.0)
    launches = dict(kadam.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors; the parameter of 'w' is on cpu"):
        kadam.adamw_update_cuda(p, {"w": torch.ones(4)}, {"w": torch.zeros(4)},
                                {"w": torch.zeros(4)}, **hyper)
    assert kadam.LAUNCHES == launches


def test_the_ops_declare_what_they_write():
    update = torch.ops.repro_torch.adamw_update.default._schema
    written = [a.name for a in update.arguments if a.alias_info and a.alias_info.is_write]
    assert written == ["params", "m", "v"] and not update.returns
    norm = torch.ops.repro_torch.adamw_sq_norm.default._schema
    assert not any(a.alias_info and a.alias_info.is_write for a in norm.arguments)


def test_a_dry_run_counts_the_kernels_bytes():
    """On fake tensors the two ops launch nothing (their fake
    implementations) and the dry run's Reckoner counts what the kernels
    move: 4 bytes a parameter for the norm (and its partials), 28 for the
    update (g, p, m, v read, p, m, v written) and the partials it reads."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import Reckoner

    sizes = (5, 4097, 0)
    with FakeTensorMode():
        leaves = [[torch.empty(n) for n in sizes] for _ in range(4)]
        with Reckoner(leaves) as counter:
            partials = torch.ops.repro_torch.adamw_sq_norm(leaves[3])
            norm_bytes = counter.bytes
            torch.ops.repro_torch.adamw_update(*leaves, partials, 1e-3, 0.9, 0.999, 0.1,
                                               0.001, 1e-8, 0.0, 1.0)
    n, parts = sum(sizes), partials.numel() * 4
    assert parts == kadam.NORM_BLOCKS * 4
    assert norm_bytes == 4 * n + parts
    assert counter.bytes - norm_bytes == 28 * n + parts
