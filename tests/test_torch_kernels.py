"""Port kernels (repro_torch.kernels) against the JAX reference on the CPU.

On the CPU the port's ``ops.fl_gains``/``ops.fl_gains_argmax`` run their
plain-torch twins (the CUDA kernels are held against those twins on the
card by ``chip_smoke.py``).  The reference runs its Pallas kernels in
interpret mode through ``repro.kernels.ops`` and its dense oracle
``repro.kernels.ref.fl_gains_ref``.

Tolerance on gains: rtol 1e-5 plus atol = 4·√ε₃₂·max‖x‖ + 8·n·ε₃₂·d_max.
The first term is the self-distance rounding of ‖x‖² + ‖e‖² − 2·x·e, which
each framework's dot order leaves at ~√ε₃₂·‖x‖ instead of 0; the second is
fp32 summation over n rows of terms ≤ d_max.  Winners must agree unless the
two picks are within that tolerance of each other (the tie rule).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fl_gains as kfl, ops, ref

# n = 65: one row past a 64-row pool tile of the CUDA kernel; d = 257: past
# its 64-wide resident cap, walked in chunks.
SIZES = (1, 7, 65, 129, 1000)
DIMS = (3, 22, 130, 257)
EPS32 = float(np.finfo(np.float32).eps)


def _inputs(n, m, d, seed, self_pairs):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    e = x[:m] if self_pairs else rng.normal(size=(m, d)).astype(np.float32)
    sqx = (x.astype(np.float32) ** 2).sum(1, dtype=np.float32)
    sqe = (e.astype(np.float32) ** 2).sum(1, dtype=np.float32)
    d_max = np.float32(2.0 * np.sqrt(max(sqx.max(), sqe.max())) + 1e-6)
    cur = rng.uniform(0.0, 0.5 * d_max, size=n).astype(np.float32)
    return x, e, cur, sqx, sqe, d_max


def _tol(x, e, n, d_max):
    norm = float(max(np.linalg.norm(x, axis=1).max(), np.linalg.norm(e, axis=1).max()))
    return 4.0 * np.sqrt(EPS32) * norm + 8.0 * n * EPS32 * float(d_max)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", SIZES)
def test_fl_gains_matches_reference(n, d):
    m = n
    for self_pairs in (True, False):
        x, e, cur, sqx, sqe, d_max = _inputs(n, m, d, seed=n * 31 + d, self_pairs=self_pairs)
        got = ops.fl_gains(_t(x), _t(e), _t(cur), _t(sqx), _t(sqe), float(d_max)).numpy()
        pallas = np.asarray(jops.fl_gains(x, e, cur, sqx, sqe, d_max))
        oracle = np.asarray(jref.fl_gains_ref(x, e, cur, d_max))
        tol = _tol(x, e, n, d_max)
        assert got.shape == (m,) and got.dtype == np.float32
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=tol)
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=tol)
        # the port's own dense oracle agrees with its blockwise twin
        mine = ref.fl_gains_ref(_t(x), _t(e), _t(cur), float(d_max)).numpy()
        np.testing.assert_allclose(got, mine, rtol=1e-5, atol=tol)


def _winner(pg, pi):
    pg, pi = np.asarray(pg), np.asarray(pi)
    return int(pi[int(np.argmax(pg))])


@pytest.mark.parametrize("tile_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", SIZES)
def test_fl_gains_argmax_matches_reference(n, d, tile_dtype):
    x, e, cur, sqx, sqe, d_max = _inputs(n, n, d, seed=n * 17 + d, self_pairs=True)
    rng = np.random.default_rng(n + d)
    chosen = rng.random(n) < 0.3
    chosen[: min(n, 128)] = n > 128  # a fully chosen first block of 128
    if chosen.all():
        chosen[-1] = False
    g, pg, pi = ops.fl_gains_argmax(
        _t(x), _t(x), _t(cur), _t(sqx), _t(sqx), float(d_max), _t(chosen),
        tile_dtype=tile_dtype,
    )
    jg, jpg, jpi = jops.fl_gains_argmax(
        x, x, cur, sqx, sqx, d_max, chosen, tile_dtype=tile_dtype
    )
    jg = np.asarray(jg)
    # bf16 tiles: both sides round the features to bf16 and multiply in fp32
    tol = _tol(x, x, n, d_max)
    if tile_dtype == "bfloat16":
        tol += 4.0 * np.sqrt(2.0**-8) * float(np.linalg.norm(x, axis=1).max())
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=tol)
    live = np.where(chosen, -np.inf, jg)
    w_port, w_ref = _winner(pg, pi), _winner(jpg, jpi)
    assert not chosen[w_port]
    assert w_port == w_ref or abs(live[w_port] - live[w_ref]) <= tol
    np.testing.assert_allclose(float(pg.max()), float(np.max(jpg)), rtol=1e-5, atol=tol)
    assert pg.shape == (-(-n // kfl.PLAIN_BLOCK_M),) and pi.dtype == torch.int32
    # at the kernel's 128-wide blocks the all-chosen first block reports ≤ −1e29
    td = ops.TILE_DTYPES[tile_dtype]
    _, pg128, pi128 = kfl.fl_gains_argmax_torch(
        _t(x).to(td), _t(x).to(td), _t(cur), _t(sqx), _t(sqx), torch.tensor(d_max),
        _t(chosen), block_m=128,
    )
    assert pg128.shape == (-(-n // 128),) and _winner(pg128, pi128) == w_port
    if n > 128:
        assert float(pg128[0]) <= -1e29


def test_fl_gains_argmax_all_chosen_reports_dead_blocks():
    x, _, cur, sqx, _, d_max = _inputs(300, 300, 5, seed=3, self_pairs=True)
    chosen = np.ones(300, bool)
    _, pg, pi = ops.fl_gains_argmax(
        _t(x), _t(x), _t(cur), _t(sqx), _t(sqx), float(d_max), _t(chosen)
    )
    _, jpg, _ = jops.fl_gains_argmax(x, x, cur, sqx, sqx, d_max, chosen)
    assert (pg.numpy() <= -1e29).all() and (np.asarray(jpg) <= -1e29).all()
    assert ((pi >= 0) & (pi < 300)).all()


def test_plain_twin_block_width_does_not_change_the_winner():
    x, _, cur, sqx, _, d_max = _inputs(1000, 1000, 22, seed=5, self_pairs=True)
    chosen = np.zeros(1000, bool)
    chosen[::7] = True
    args = (_t(x), _t(x), _t(cur), _t(sqx), _t(sqx), torch.tensor(float(d_max)), _t(chosen))
    wins = {_winner(*kfl.fl_gains_argmax_torch(*args, block_m=bm)[1:]) for bm in (64, 128, 2048)}
    wins.add(_winner(*ops.fl_gains_argmax(*args)[1:]))
    assert len(wins) == 1


def test_pairwise_l2_ref_matches_reference():
    x, e, *_ = _inputs(129, 7, 22, seed=9, self_pairs=False)
    got = ref.pairwise_l2_ref(_t(x), _t(e)).numpy()
    want = np.asarray(jref.pairwise_l2_ref(jnp.asarray(x), jnp.asarray(e)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_ops_reject_unknown_impl_and_dtype():
    x, _, cur, sqx, _, d_max = _inputs(7, 7, 3, seed=1, self_pairs=True)
    with pytest.raises(ValueError, match="gains_impl"):
        ops.fl_gains(_t(x), _t(x), _t(cur), _t(sqx), _t(sqx), float(d_max), gains_impl="jax")
    with pytest.raises(ValueError, match="tile_dtype"):
        ops.fl_gains_argmax(
            _t(x), _t(x), _t(cur), _t(sqx), _t(sqx), float(d_max),
            torch.zeros(7, dtype=torch.bool), tile_dtype="float16",
        )
