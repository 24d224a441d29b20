"""The port's explicit collectives (``distributed/collectives.py``) and the
group form of ``distributed.compression.compressed_psum``, over four gloo
processes on the CPU, against the reference's functions run under
``shard_map`` on four forced host devices.

Both sides get the same seeded per-rank inputs.  The reference runs in one
subprocess (``XLA_FLAGS`` must force the devices before JAX starts, which
a test process cannot promise), the port in one spawn of four ranks
(``tests/torch_mesh_worker.py``), each once for the module.  The sums of
``psum_mean``, ``reduce_scatter_mean`` and ``compressed_psum`` are gloo's
(or the port's rank-order) and XLA's reductions of four fp32 values, held
within 1e-6 relative (an ulp or two); the gather is exact, and the group
form of ``compressed_psum`` equals, bit for bit, its list form and the
reference's dequantized payloads summed in rank order.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
import torch_mesh_worker
import torch_threads  # noqa: F401 — one intra-op thread a worker

_REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.distributed import compat_shard_map
from repro.distributed import collectives as coll
from repro.distributed.compression import compressed_psum
from repro.launch.mesh import compat_mesh

mesh = compat_mesh((4,), ("data",))
xs = np.stack([np.random.RandomState(10 + r).randn(6, 5).astype(np.float32) for r in range(4)])
big = np.stack([np.random.RandomState(20 + r).randn(3, 300).astype(np.float32) for r in range(4)])

def mapped(body, x):
    f = compat_shard_map(lambda a: body(a[0])[None], mesh=mesh, in_specs=P("data"),
                         out_specs=P("data"))
    return np.asarray(jax.jit(f)(x))

out = {
    "psum_mean": mapped(lambda a: coll.psum_mean({"a": a}, "data")["a"], xs),
    "reduce_scatter_mean": mapped(lambda a: coll.reduce_scatter_mean(a, "data"), xs),
    "all_gather_params": mapped(lambda a: coll.all_gather_params(
        coll.reduce_scatter_mean(a, "data"), "data", a.shape[0]), xs),
    "compressed_psum": mapped(lambda a: compressed_psum(a, "data"), big),
}
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collectives"))
    ref_path = os.path.join(out, "reference.npz")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join([src, os.environ.get(
               "PYTHONPATH", "")])}
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, ref_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        torch_mesh_worker.launch("collectives", out)
        log = ref.communicate(timeout=240)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    got = torch.load(os.path.join(out, "collectives.pt"))
    return {k: v.numpy() for k, v in got.items()}, dict(np.load(ref_path))


def test_all_gather_params_is_the_references(results):
    got, want = results
    # the gather of the reduce-scattered rows, padding dropped: exactly the
    # ranks' rows in rank order, and the reference's within its sums
    np.testing.assert_array_equal(got["all_gather_params"],
                                  got["reduce_scatter_mean_all"].reshape(8, 5)[:6])
    np.testing.assert_allclose(got["all_gather_params"], want["all_gather_params"][0],
                               rtol=1e-6, atol=1e-7)


def test_reduce_scatter_mean_pads_and_is_the_references(results):
    got, want = results
    # 6 rows over 4 ranks: padded to 8, two rows a rank, the last rank's zero
    assert got["reduce_scatter_mean_all"].shape == (4, 2, 5)
    np.testing.assert_array_equal(got["reduce_scatter_mean_all"][3, 1:], 0.0)
    np.testing.assert_allclose(got["reduce_scatter_mean_all"], want["reduce_scatter_mean"],
                               rtol=1e-6, atol=1e-7)


def test_psum_mean_is_the_references(results):
    got, want = results
    np.testing.assert_allclose(got["psum_mean"], want["psum_mean"][0], rtol=1e-6, atol=1e-7)


def test_compressed_psum_group_form_is_the_references_and_the_list_forms(results):
    got, want = results
    for r in range(4):  # every reference rank reconstructs the same mean
        np.testing.assert_array_equal(want["compressed_psum"][r], want["compressed_psum"][0])
    np.testing.assert_allclose(got["compressed_psum"], want["compressed_psum"][0],
                               rtol=1e-6, atol=2e-7)
    np.testing.assert_array_equal(got["compressed_psum"], got["compressed_psum_list"])
    total = np.zeros((3, 300), np.float32)
    for r in range(4):  # the reference's wire, dequantized and summed in rank order
        x = np.random.RandomState(20 + r).randn(3, 300).astype(np.float32)
        q, s = JC.quantize_int8(jnp.asarray(x))
        total = total + np.asarray(JC.dequantize_int8(q, s, x.shape))
    np.testing.assert_array_equal(got["compressed_psum"], total / np.float32(4))
