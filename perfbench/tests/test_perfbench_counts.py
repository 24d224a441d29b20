"""The yardstick's arithmetic against hand counts, and the weights' layout
against the program's."""
import math

import pytest
import torch

from perfbench import counts, weights
from perfbench.model_shape import Shape
from perfbench.tests.tiny import TINY_CONFIG

TINY = Shape.from_config("tiny", TINY_CONFIG)


def test_matmul_params_by_hand():
    # d 64, 4 heads of 16, 2 kv heads, d_ff 96, 2 layers, V 250
    layer = 64 * 16 * 4 + 2 * 64 * 16 * 2 + 64 * 64 + 3 * 64 * 96
    assert TINY.matmul_params(head=False) == 2 * layer
    assert TINY.matmul_params(head=True) == 2 * layer + 250 * 64


def test_flops_by_hand():
    n = TINY.matmul_params(head=True)
    attn = 2 * (2 * 4 * 16 * 16 * 4 * 16)  # 2 layers × 2·B·T²·H·hd
    assert counts.train_step_flops(TINY, 4, 16) == 6 * n * 64 + 3 * attn
    n0 = TINY.matmul_params(head=False)
    assert counts.extract_flops(TINY, 4, 16) == 2 * n0 * 64 + attn + 4 * 64 * 64 * 250


def test_ce_proxy_bound_by_hand():
    t, kind = counts.ce_proxy_bound_s(4096, 3584, 152064, 2, 989e12, 3.35e12)
    assert kind == "ops" and t == pytest.approx(4 * 4096 * 3584 * 152064 / 989e12)
    t, kind = counts.ce_proxy_bound_s(1, 64, 250, 2, 989e12, 3.35e12)
    assert kind == "bytes"
    assert t == pytest.approx((2 * (64 + 250 * 64) + 4 + 4 * 64) / 3.35e12)


def test_peaks_need_a_published_card():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    with pytest.raises(ValueError):
        counts.peaks("some other card")


def test_layout_is_the_programs():
    from perfbench.runners.train import port_config
    from repro_torch.models import param_shapes

    want = {n: tuple(s) for n, s, _, _ in TINY.leaves()}
    assert param_shapes(port_config(TINY)) == want


def test_weights_are_the_seeds_and_groups_redraw_alone():
    a = weights.make_params(TINY, 2**31 + 7, "cpu")
    b = weights.make_params(TINY, 2**31 + 7, "cpu")
    c = weights.make_params(TINY, 2**31 + 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    g = weights.group(TINY, 2**31 + 7, "layers.1", "cpu")
    assert all(torch.equal(g[k], a[k]) for k in g)
    assert float(a["layers.0.mixer.wq"].abs().max()) <= 2 / math.sqrt(64) + 1e-7
    assert torch.equal(a["layers.0.norm1.scale"], torch.ones(64))
