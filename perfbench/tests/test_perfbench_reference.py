"""The plain reference against the program at a tiny size on the CPU, the
program computing in fp32 for the comparison."""
import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.corpus import Corpus
from perfbench.runners.train import port_config
from perfbench.model_shape import Shape
from perfbench.reference import greedy as rg
from perfbench.reference import model as rm
from perfbench.reference.training import adamw_steps
from perfbench.tests.tiny import TINY_CONFIG

TINY = Shape.from_config("tiny", TINY_CONFIG)
SEED = 2**31 + 11


@pytest.fixture
def fp32_program(monkeypatch):
    from repro_torch.models import model as pm

    monkeypatch.setattr(pm, "COMPUTE_DTYPE", torch.float32)
    return pm


def _batch(n=4):
    c = Corpus(32, 16, TINY.vocab_size, 4, SEED)
    idx = np.arange(3, 3 + n)
    return torch.as_tensor(c.tokens(idx)), torch.as_tensor(c.labels(idx))


def test_corpus_is_the_programs_token_stream():
    from repro_torch.data.synthetic import TokenStream

    c = Corpus(12, 16, 250, 4, SEED)
    ts = TokenStream(12, 16, 250, n_topics=4, seed=SEED)
    idx = np.array([0, 5, 11])
    got, want = c.batch(idx), ts.batch(idx)
    assert np.array_equal(got["tokens"], want["tokens"])
    assert np.array_equal(got["labels"], want["labels"])


def test_loss_and_gradients_are_the_programs(fp32_program):
    p = weights.make_params(TINY, SEED, "cpu")
    tok, lab = _batch()
    w = torch.tensor([1.0, 0.5, 2.0, 1.5])
    cfg = port_config(TINY)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    total, _ = fp32_program.loss_fn(leaves, cfg, {"tokens": tok, "labels": lab, "weights": w})
    total.backward()
    ref_leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = rm.weighted_loss(ref_leaves, TINY, tok, lab, w, rm.Matmul("fp32"), rows=3)
    assert float(loss) == pytest.approx(float(total.detach()), rel=1e-5)
    for k in p:
        torch.testing.assert_close(ref_leaves[k].grad, leaves[k].grad, rtol=1e-4, atol=1e-6)


def test_proxy_features_are_the_programs(fp32_program):
    p = weights.make_params(TINY, SEED, "cpu")
    tok, lab = _batch()
    want = fp32_program.proxy_features(p, port_config(TINY), {"tokens": tok, "labels": lab})
    got = rm.proxy_features(p, TINY, tok, lab, rm.Matmul("fp32"), rows=3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_adamw_is_the_programs(fp32_program):
    from repro_torch.optim import adamw, constant
    from repro_torch.train.train_step import make_train_step

    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.0, "clip": 1.0}
    p = weights.make_params(TINY, SEED, "cpu")
    p0 = {k: v.clone() for k, v in p.items()}
    q = {k: v.clone() for k, v in p.items()}
    tok, lab = _batch()
    ones = torch.ones(4)
    batches = [(tok, lab, ones), (tok.flip(0), lab.flip(0), ones)]
    ref = adamw_steps(q, TINY, batches, opt, rm.Matmul("fp32"), rows=2)
    optimizer = adamw(constant(opt["lr"]), clip=opt["clip"])
    step = make_train_step(port_config(TINY), optimizer)
    state = optimizer.init(p)
    losses = []
    for t, y, w in batches:
        p, state, m = step(p, state, {"tokens": t, "labels": y, "weights": w})
        losses.append(float(m["loss"]))
    assert ref["losses"] == pytest.approx(losses, rel=1e-5)
    # Adam's step is ±lr wherever |g| ≫ eps, whatever g's size, so elements
    # with a gradient near rounding may step apart; each leaf's change agrees
    for k in p:
        a, b = float((q[k] - p0[k]).norm()), float((p[k] - p0[k]).norm())
        assert a == pytest.approx(b, rel=1e-3, abs=1e-9), k


def test_fp8_control_is_coarser_than_fp32():
    p = weights.make_params(TINY, SEED, "cpu")
    tok, lab = _batch()
    a = rm.proxy_features(p, TINY, tok, lab, rm.Matmul("fp32"), rows=4)
    b = rm.proxy_features(p, TINY, tok, lab, rm.Matmul("fp8"), rows=4)
    gap = float(((a - b).norm(dim=1) / a.norm(dim=1)).max())
    assert 1e-3 < gap < 0.5


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("warm", [0, 5])
def test_greedy_is_the_programs_matrix_engine(seed, warm):
    """The engine's fp32 greedy and the fp64 reference pick the same set or,
    past a near-tie, sets of the same coverage; γ are the fp64 cluster
    sizes of the engine's own picks."""
    from repro_torch.core.engines.matrix import MatrixConfig, MatrixEngine

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(96, 8, generator=g) * torch.rand(96, 1, generator=g).add(0.5)
    init = list(range(0, 2 * warm, 2))
    res = MatrixEngine(MatrixConfig()).select(x, 20, init_selected=init or None)
    dist = rg.distances(x)
    want = rg.greedy(dist, 20, init)
    mine = res.indices.tolist()
    assert mine[:warm] == init
    assert rg.coverage(dist, mine) == pytest.approx(rg.coverage(dist, want), rel=1e-3)
    assert res.weights.double().tolist() == rg.cluster_sizes(dist, mine).tolist()
    # fp32 distances from ‖x‖² + ‖y‖² − 2x·y: self-distances round above 0
    assert float(res.coverage) == pytest.approx(rg.coverage(dist, mine), rel=1e-4)


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    import perfbench.reference as ref_pkg

    for path in Path(ref_pkg.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax"), (path, name)
