"""The train, select and serve steps on a mesh of DTensors
(``distributed/sharding.py``, ``distributed/annotate.py``,
``train/train_step.py``), over four gloo processes on the CPU, against
the same steps without a mesh on the same inputs.

One spawn of four ranks for the module (``tests/torch_mesh_worker.py``):

* on a 2×2 ``("data", "model")`` mesh, one AdamW step of the dense, MoE,
  Griffin and xLSTM smoke configs (one pattern period each) with fp32
  products: the loss within 1e-3 relative and every gradient within 1e-2
  (‖Δg‖/‖g‖) of the unsharded step's, and within 1e-5 and 1e-4 beside
  those bounds, AdamW's moments placed like their parameters.  With fp32
  products the shards' partial sums differ from one product by fp32
  rounding alone (measured on this suite's CPU: loss ≤ 7.4e-8, gradients
  ≤ 1.1e-6), which the tighter bounds hold with 100× to spare;
* ``grad_transform`` = the group form of ``compressed_psum`` over the data
  group: the step hands the hook each replica's own gradient, and the
  result equals the list form over the replicas' gradients computed
  without a mesh, each on its own rows;
* a checkpoint saved on the 2×2 mesh and restored onto a 4×1 mesh;
* on a (1, 1) mesh, in a group of one, the bf16 train step (two
  microbatches for the dense config), a select step and eight decode
  steps, bit for bit the unsharded ones.
"""
import json
import os

import pytest

import torch_mesh_worker
import torch_threads  # noqa: F401 — one intra-op thread a worker

FAMILIES = list(torch_mesh_worker.FAMILIES)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_step"))
    torch_mesh_worker.launch("sharded_step", out)
    with open(os.path.join(out, "sharded_step.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("family", FAMILIES)
def test_step_on_a_2x2_mesh_holds_to_the_unsharded_step(res, family):
    r = res[family]
    assert r["loss_rel"] <= 1e-3, r["loss_rel"]
    worst = max(r["grad_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-2, worst
    # and closer: fp32 rounding is ~1e-7 here, a partial sum reduced or
    # placed in bf16 (~1e-3) is not
    assert r["loss_rel"] <= 1e-5, r["loss_rel"]
    assert worst[1] <= 1e-4, worst
    assert r["moments_placed_like_params"]


def test_compressed_grad_transform_over_the_data_group(res):
    """Each replica's own gradient goes on the int8 wire: the hook's result
    equals the list form over the replicas' gradients computed apart
    (fp32 rounding, ~2e-7, and an int8 code it moves at a boundary, up to
    1.8e-4 measured) and lies far from the wire over the reduced gradient
    (≥ 2.9e-3 measured), which quantizes the mean instead."""
    r = res["compressed"]
    assert r["loss_rel"] <= 1e-5, r["loss_rel"]
    worst = max(r["grad_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-3, worst
    nearest = min(r["reduced_first_rel"].items(), key=lambda kv: kv[1])
    assert nearest[1] > 1e-3, nearest
    # the hook ran: the int8 wire moved the gradients off the raw ones
    assert r["raw_grad_rel"] > 1e-4


def test_identity_grad_transform_on_a_mesh_is_the_step_without_one(res):
    """A hook that hands back each replica's gradient untouched: the step
    reduces the pending means itself, to the unsharded gradients within
    fp32 rounding."""
    worst = max(res["compressed"]["identity_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst


def test_checkpoint_saved_on_2x2_restores_onto_4x1(res):
    assert res["checkpoint"] == {"restored_equal": True, "restored_placed": True, "step": 0}


@pytest.mark.parametrize("family", FAMILIES)
def test_step_on_a_1x1_mesh_is_bit_for_bit(res, family):
    assert res["one"][family]["bitwise"], res["one"][family]["loss_rel"]


def test_select_and_decode_on_a_1x1_mesh_are_bit_for_bit(res):
    assert res["one"]["serving"] == {"select_bitwise": True, "decode_bitwise": True}
