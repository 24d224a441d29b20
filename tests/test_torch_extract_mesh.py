"""Proxy extraction over a ``torch.distributed`` group, one program a rank
(``core/distributed.py::make_distributed_extract`` and
``core/extract.py::ProxyExtractor`` over a one-axis ``DeviceMesh``), and
the refresh it feeds: the two rounds over the same group.  Over gloo on
the CPU.

One spawn of four ranks for the module (``tests/torch_mesh_worker.py``,
case ``extract_mesh``): the four ranks, then ranks 0–1 in a group of two,
then rank 0 alone.  The model is ``test_torch_distributed.py``'s small
dense config (2 layers, d 32, vocab 128, fp32 compute) with the
reference's weights, and the pool its ragged one (19 docs in batches of 4,
whose plan pads to 8 batches over four shards), at megabatches 3 and 1.
On every rank and group size the features must be bit for bit the
single-controller ``Mesh`` form over as many shards and the single-device
extract, gathered once a dispatch, and within rtol 1e-4, atol 1e-5 of the
reference's ``ProxyExtractor``.  The extract fed to
``CraigSelector.select_distributed`` over the same mesh must give every
rank the single-controller composition's indices, γ and coverage bit for
bit, and over four ranks the reference's two rounds on those features
under the tie rule of ``repro_torch.parity``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from repro.core.extract import ProxyExtractor as JProxyExtractor
from repro.data.synthetic import TokenStream as JTokenStream
from repro.distributed import tree_select as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.train.train_step import make_select_step as jmake_select_step
from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.core.extract import ProxyExtractor, make_scan_extract
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.config import ModelConfig
from repro_torch.train.train_step import make_select_step
from test_torch_distributed import ENGINES, cpu_mesh, hold_final, hold_stages, replay
from torch_lm_checks import ref_init
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

WORLDS = (4, 2, 1)
RUNS = [(w, mb, pf) for w in WORLDS for mb, pf in W.EXTRACT_RUNS]


@pytest.fixture(scope="module")
def fp32():
    """Both packages compute in fp32 for the module (the tight checks)."""
    import repro.models.model as jmodel
    from repro_torch.models import model as tmodel

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
        yield


@pytest.fixture(scope="module")
def weights(fp32):
    jcfg = JModelConfig(**W.EXTRACT_CFG)
    jp = ref_init(jcfg, 1)
    tp = convert.model_params_from_reference(jax.tree.map(np.asarray, jp),
                                             ModelConfig(**W.EXTRACT_CFG), device="cpu")
    return jcfg, jp, tp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    out = str(tmp_path_factory.mktemp("extract_mesh"))
    torch.save(weights[2], os.path.join(out, "extract_params.pt"))
    W.launch("extract_mesh", out)
    return [torch.load(f"{out}/extract_mesh.{r}.pt", weights_only=False) for r in range(4)]


@pytest.fixture(scope="module")
def here(weights):
    """(select_fn, dataset, params) of the in-process extracts, as the
    ranks' (``torch_mesh_worker.extract_setup``)."""
    cfg = ModelConfig(**W.EXTRACT_CFG)
    ds = TokenStream(n_docs=W.EXTRACT_DOCS, seq_len=W.EXTRACT_SEQ, vocab_size=cfg.vocab_size)
    return make_select_step(cfg, "auto"), ds, weights[2]


@pytest.mark.parametrize("world,megabatch,prefetch", RUNS,
                         ids=[f"on-{w}-mb{mb}-{'prefetch' if pf else 'inline'}"
                              for w, mb, pf in RUNS])
def test_rank_extract_is_the_mesh_form_and_the_single_device_extract(ranks, here, world,
                                                                      megabatch, prefetch):
    select, ds, params = here
    single = ProxyExtractor(select, ds, W.EXTRACT_B, megabatch=megabatch,
                            prefetch=prefetch).extract(params, W.EXTRACT_POOL)
    meshed = ProxyExtractor(select, ds, W.EXTRACT_B, megabatch=megabatch, prefetch=prefetch,
                            mesh=cpu_mesh(world))
    mesh_feats = meshed.extract(params, W.EXTRACT_POOL)
    assert torch.equal(mesh_feats, single)
    plan = meshed._plan(len(W.EXTRACT_POOL))
    for r in ranks[:world]:
        feats, calls, rank_plan, own = r[(world, megabatch, prefetch)]
        assert feats.shape == (len(W.EXTRACT_POOL), W.EXTRACT_CFG["d_model"])
        assert torch.equal(feats, single)
        assert rank_plan == plan and calls == len(plan)  # one gather a dispatch
        assert own  # the rank's own slice of each dispatch, bit for bit
    if world == 4:
        assert plan == [(0, 4), (4, 4)]  # 5 batches padded to 8


@pytest.mark.parametrize("world", WORLDS)
def test_function_form_over_ranks(ranks, here, world):
    """``make_distributed_extract`` over the rank mesh on one whole
    megabatch of 2·world batches: bit for bit its ``Mesh`` form and the one
    scan body on one device."""
    select, ds, params = here
    ex = ProxyExtractor(select, ds, W.EXTRACT_B)
    batches = {k: torch.as_tensor(v)
               for k, v in ex._assemble(W.EXTRACT_POOL, 0, 2 * world).items()}
    want = make_scan_extract(select)(params, batches)
    assert torch.equal(D.make_distributed_extract(select, cpu_mesh(world))(params, batches),
                       want)
    for r in ranks[:world]:
        assert torch.equal(r[(world, "fn")], want)


@pytest.mark.parametrize("megabatch", [3, 1])
def test_rank_extract_is_the_references(ranks, weights, megabatch):
    jcfg, jp, _ = weights
    jds = JTokenStream(n_docs=W.EXTRACT_DOCS, seq_len=W.EXTRACT_SEQ,
                       vocab_size=jcfg.vocab_size)
    want = np.asarray(JProxyExtractor(jmake_select_step(jcfg, "einsum"), jds, W.EXTRACT_B,
                                      megabatch=megabatch).extract(jp, W.EXTRACT_POOL))
    for world in WORLDS:
        for r in ranks[:world]:
            np.testing.assert_allclose(r[(world, megabatch, True)][0].numpy(), want,
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_extract_then_two_rounds_over_the_same_group(ranks, here, world):
    """One refresh over the group: every rank's selection is the
    single-controller composition's bit for bit (extract over a ``Mesh``,
    then ``select_distributed`` over it); over four ranks also the
    reference's two rounds on the same features under the tie rule."""
    select, ds, params = here
    pool = np.arange(W.EXTRACT_DOCS)
    feats = ProxyExtractor(select, ds, W.EXTRACT_B, megabatch=3,
                           mesh=cpu_mesh(world)).extract(params, pool)
    selector = CraigSelector(CraigConfig(fraction=W.EXTRACT_FRACTION, per_class=False),
                             device="cpu")
    want = selector.select_distributed(feats, cpu_mesh(world))
    for r in ranks[:world]:
        f, idx, w, cov, engine = r[(world, "composition")]
        assert torch.equal(f, feats)
        np.testing.assert_array_equal(idx, want.indices)
        np.testing.assert_array_equal(w, want.weights)
        assert cov == want.coverage and engine == want.engine
        assert float(np.sum(w, dtype=np.float64)) == W.EXTRACT_DOCS
    if world != 4:
        return
    # the reference's two rounds on these features: its one-level fp32 tree
    # over the four shards (this process has one JAX device)
    x = feats.numpy()
    r_final = want.size
    r_local = max(1, min(len(x) // world, int(r_final * 2 / world) + 1))
    assert want.engine == {"name": "matrix"}
    ref_sel = JT.tree_select_host(jnp.asarray(x), JT.TreeTopology((world,)), r_local,
                                  r_final, compress="none")
    diverged = hold_stages(
        replay("ref", x, (world,), r_local, r_final, "none", ENGINES["matrix"][0]),
        replay("port", x, (world,), r_local, r_final, "none", ENGINES["matrix"][1]))
    got = D.DistributedSelection(torch.as_tensor(want.indices), torch.as_tensor(want.weights),
                                 torch.tensor(want.coverage, dtype=torch.float32))
    hold_final(x, ref_sel, got, diverged, r_final)


def test_errors_over_ranks(ranks):
    """A batch count that does not split over the group raises on every
    rank, as the ``Mesh`` form does; so does a mesh whose dim is not named
    ``axis_name``."""
    for world in (4, 2):
        for r in ranks[:world]:
            assert r[(world, "ragged")] == (f"{world + 1} batches do not split over the "
                                            f"{world}-shard axis 'data'")
    for world in WORLDS:
        for r in ranks[:world]:
            for msg in r[(world, "misnamed")]:
                assert "a DeviceMesh must have the one axis" in msg
            assert "('data',), got ('model',)" in r[(world, "misnamed")][0]
            assert "('pool',), got ('data',)" in r[(world, "misnamed")][2]
    with pytest.raises(ValueError, match="5 batches do not split over the 4-shard axis"):
        D.make_distributed_extract(lambda p, b: None, cpu_mesh(4))(
            {}, {"tokens": torch.zeros(5, 4, 16)})
