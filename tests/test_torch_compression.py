"""Port int8 codecs (``repro_torch.distributed.compression``) against the
reference's (``repro.distributed.compression``) on the same numpy inputs.

Codes and scales must be equal, not close: the candidate wire of the tree
drivers carries them, and the process driver is held bit for bit to the
host driver.  The 20,000 × 256 draw holds values at which a multiply by
the reciprocal scale rounds to another code than the true division XLA
computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.distributed import compression as C
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((20_000, 256), 1), ((7, 3), 2), ((1, 1), 3),
                                        ((300, 54), 4)])
def test_row_codes_and_scales_equal_the_reference(shape, seed):
    x = _x(shape, seed, scale=3.0)
    x[::5, 0] = 0.0
    jq, js = JC.quantize_rows_int8(jnp.asarray(x))
    q, s = C.quantize_rows_int8(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(C.dequantize_rows_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_rows_int8(jq, js)))


def test_row_codec_differs_from_a_reciprocal_multiply_somewhere():
    # the draw of the first case really discriminates division from a
    # multiply by 1/scale, so its equality above is a statement about that
    x = torch.as_tensor(_x((20_000, 256), 1, scale=3.0))
    q, s = C.quantize_rows_int8(x)
    qm = torch.clamp(torch.round(x * (1.0 / s)[:, None]), -127, 127).to(torch.int8)
    assert int((qm != q).sum()) > 0


@pytest.mark.parametrize("shape,seed", [((1000,), 5), ((37, 11), 6), ((256,), 7),
                                        ((3, 5, 17), 8)])
def test_block_codes_and_scales_equal_the_reference(shape, seed):
    x = _x(shape, seed, scale=0.01)
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(torch.as_tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        C.dequantize_int8(q, s, shape).numpy(),
        np.asarray(JC.dequantize_int8(jq, js, shape)))


def test_row_round_trip_bound_and_bf16():
    x = _x((128, 64), 9, scale=5.0)
    t = torch.as_tensor(x)
    q, s = C.quantize_rows_int8(t)
    back = C.dequantize_rows_int8(q, s)
    err = (back - t).abs().amax(dim=1)
    assert bool((err <= s / 2 * (1 + 1e-5) + 1e-7).all())
    qb, sb = C.quantize_rows_int8(t.to(torch.bfloat16))
    jqb, jsb = JC.quantize_rows_int8(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))
    with pytest.raises(ValueError, match="2-D"):
        C.quantize_rows_int8(torch.zeros(4))


def test_block_round_trip_bound():
    x = _x((3000,), 10)
    t = torch.as_tensor(x)
    q, s = C.quantize_int8(t)
    back = C.dequantize_int8(q, s, (3000,))
    per_block = s.repeat_interleave(256)[:3000]
    assert bool(((back - t).abs() <= per_block / 2 * (1 + 1e-5) + 1e-7).all())


@pytest.mark.parametrize("peers", [1, 4, 8])
def test_compressed_psum_equals_the_mean_of_the_reference_dequantized_peers(peers):
    xs = [_x((37, 5), 20 + p) for p in range(peers)]
    total = np.zeros((37, 5), np.float32)
    for x in xs:  # the reference's per-peer wire, summed in peer order
        jq, js = JC.quantize_int8(jnp.asarray(x))
        total = total + np.asarray(JC.dequantize_int8(jq, js, x.shape))
    got = C.compressed_psum([torch.as_tensor(x) for x in xs])
    np.testing.assert_array_equal(got.numpy(), total / np.float32(peers))
    with pytest.raises(ValueError, match="shapes differ"):
        C.compressed_psum([torch.zeros(3), torch.zeros(4)])


def test_error_feedback_matches_the_reference_over_three_steps():
    grads = [{"w": _x((40, 7), 30 + s, 0.1), "b": _x((7,), 40 + s, 0.1)} for s in range(3)]
    jinit, japply = JC.make_error_feedback({k: jnp.asarray(v) for k, v in grads[0].items()})
    init, apply = C.make_error_feedback({k: torch.as_tensor(v) for k, v in grads[0].items()})
    jres, res = jinit(), init()
    delivered_sum = {k: np.zeros_like(v) for k, v in grads[0].items()}
    for g in grads:
        jdel, jres = japply({k: jnp.asarray(v) for k, v in g.items()}, jres)
        dlv, res = apply({k: torch.as_tensor(v) for k, v in g.items()}, res)
        for k in g:
            np.testing.assert_array_equal(dlv[k].numpy(), np.asarray(jdel[k]))
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))
            delivered_sum[k] += dlv[k].numpy()
    # error feedback: what was delivered plus what is carried is what was sent
    for k in grads[0]:
        sent = sum(g[k] for g in grads)
        np.testing.assert_allclose(delivered_sum[k] + res[k].numpy(), sent, atol=1e-6)
    assert jax.tree_util.tree_structure(jres) == jax.tree_util.tree_structure(
        {k: 0 for k in grads[0]})
