"""The port's RG-LRU block (repro_torch.models.recurrent) against the JAX
reference on the CPU, in fp32.

Same numpy inputs into both; the weights are the reference's
``init_griffin_block`` draws.  Tolerances: rtol 1e-4, atol 1e-5 (the
reference's own scan-against-decode tolerance), since the port's doubling
scan reassociates the recurrence in another tree than
``lax.associative_scan``; the causal convolution is the same adds in the
same order, so it is held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch.models import recurrent as trec
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

D, R, K = 24, 16, 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(seed=0):
    jc = jrec.RGLRUConfig(d_model=D, d_rnn=R, conv_width=K)
    tc = trec.RGLRUConfig(d_model=D, d_rnn=R, conv_width=K)
    jp = jrec.init_griffin_block(jax.random.PRNGKey(seed), jc)
    # non-zero gate biases, so b_a and b_i enter the comparison
    rng = np.random.default_rng(seed)
    jp = {**jp, "b_a": jnp.asarray(rng.normal(size=R).astype(np.float32)),
          "b_i": jnp.asarray(rng.normal(size=R).astype(np.float32))}
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    return jc, tc, jp, tp


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_init_matches_the_reference_shapes_and_lambda_range():
    jc, tc, jp, _ = _setup()
    tp = trec.init_griffin_block(tc, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    a = torch.sigmoid(tp["lam"]) ** 8.0  # σ(Λ)^c, uniform in [0.9², 0.999²]
    assert bool(((a >= 0.9**2 - 1e-6) & (a <= 0.999**2 + 1e-6)).all())
    assert float(tp["b_a"].abs().max()) == 0.0 and float(tp["b_i"].abs().max()) == 0.0


@pytest.mark.parametrize("T", [1, 2, 7, 12])
def test_rglru_scan_matches_reference(T):
    _, _, jp, tp = _setup(1)
    u = _x((2, T, R), T)
    want = np.asarray(jrec._rglru_scan(jp, jnp.asarray(u)))
    got = trec._rglru_scan(tp, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_causal_conv_is_exact():
    w = _x((K, R), 2)
    x = _x((3, 9, R), 3)
    want = np.asarray(jrec._causal_conv(jnp.asarray(w), jnp.asarray(x)))
    got = trec._causal_conv(torch.as_tensor(w), torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [5, 12])
def test_griffin_block_matches_reference(T):
    jc, tc, jp, tp = _setup(4)
    x = _x((2, T, D), 5)
    want = np.asarray(jax.jit(lambda p, v: jrec.griffin_block(p, jc, v))(jp, jnp.asarray(x)))
    got = trec.griffin_block(tp, tc, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_griffin_decode_matches_reference_step_by_step():
    jc, tc, jp, tp = _setup(6)
    x = _x((2, 10, D), 7)
    step = jax.jit(lambda p, v, s: jrec.griffin_decode(p, jc, v, s))
    js = jrec.init_griffin_state(jc, 2)
    ts = trec.init_griffin_state(tc, 2, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in ts.items()} == {k: v.shape for k, v in js.items()}
    for t in range(x.shape[1]):
        jo, js = step(jp, jnp.asarray(x[:, t:t + 1]), js)
        to, ts = trec.griffin_decode(tp, tc, torch.as_tensor(x[:, t:t + 1]), ts)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL, err_msg=f"step {t}")
        for k in ("h", "conv"):
            assert ts[k].dtype == torch.float32
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL,
                                       err_msg=f"state {k}, step {t}")


def test_the_ports_scan_equals_its_decode():
    _, tc, _, tp = _setup(8)
    x = torch.as_tensor(_x((3, 12, D), 9))
    full = trec.griffin_block(tp, tc, x)
    state = trec.init_griffin_state(tc, 3, torch.device("cpu"))
    steps = []
    for t in range(x.shape[1]):
        out, state = trec.griffin_decode(tp, tc, x[:, t:t + 1], state)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), **TOL)


def test_the_scan_does_not_overflow_over_long_sequences():
    """a_t near its lower end over 4,096 steps: exp(−Σ log a) would
    overflow fp32; the doubling scan only multiplies numbers ≤ 1."""
    _, tc, _, tp = _setup(10)
    tp = {**tp, "lam": torch.full((R,), -4.0)}  # σ(Λ)^8 ≈ 1e-7 at r_t = 1
    h = trec._rglru_scan(tp, torch.as_tensor(_x((1, 4096, R), 11)))
    assert bool(torch.isfinite(h).all())
