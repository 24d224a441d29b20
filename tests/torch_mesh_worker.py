"""One rank of the port's multi-process mesh checks, over gloo on the CPU.

Run by ``tests/test_torch_sharded_step.py``,
``tests/test_torch_collectives.py``, ``tests/test_torch_tree_mesh.py`` and
``tests/test_torch_extract_mesh.py`` (four processes each), or by hand::

    PYTHONPATH=src torchrun --nproc-per-node 4 tests/torch_mesh_worker.py \\
        --case sharded_step --device cpu --out /tmp/mesh

Each rank joins the group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  Rank 0 writes what the
tests read into ``--out``: ``<case>.json`` (scalars) and ``<case>.pt``
(tensors).  Cases:

* ``sharded_step``: on a 2×2 ``("data", "model")`` mesh, one AdamW train
  step of the dense, MoE, Griffin and xLSTM smoke configs against the
  same step unsharded on the same inputs (loss, every gradient, every
  updated parameter), the step with ``grad_transform`` =
  ``compressed_psum`` over the data group (each replica's gradient on the
  int8 wire) against the list form over the replicas' gradients computed
  without a mesh (the group form is held to the reference's under
  ``shard_map`` by ``collectives``), a checkpoint saved on 2×2 and
  restored onto a 4×1 mesh; then rank 0 alone, in a group of one, the
  same steps, a select step and a decode step on a (1, 1) mesh against
  the unsharded ones, bit for bit.
* ``collectives``: ``distributed.collectives`` and the group form of
  ``compressed_psum`` on seeded per-rank inputs.
* ``tree_mesh``: ``tree_select_mesh`` over ``launch.tree.make_tree_mesh``
  on :func:`tree_pool`, every fan-out of ``TREE_CASES`` on its group size
  and both wires (the four ranks, then ranks 0–1 in a group of two, then
  rank 0 alone), the two rounds over a 4-rank ``DeviceMesh``
  (``distributed_select`` and ``CraigSelector.select_distributed``) and
  the errors of a ragged pool and of fan-outs that do not fit the group.
  Every rank writes ``tree_mesh.<rank>.pt``.
* ``extract_mesh``: ``ProxyExtractor`` and ``make_distributed_extract``
  over a one-axis ``DeviceMesh`` (the four ranks, then ranks 0–1 in a
  group of two, then rank 0 alone) with the small dense config and the
  parameters the test writes to ``<out>/extract_params.pt``: the ragged
  pool at each ``EXTRACT_RUNS`` megabatch, the features and the
  ``all_gather_into_tensor`` calls, whether each rank's own slice of each
  dispatch is the whole megabatch's; the extract fed to
  ``CraigSelector.select_distributed`` over the same mesh; and the errors
  of a batch count that does not split and of a misnamed mesh.  Every
  rank writes ``extract_mesh.<rank>.pt``.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

# (fan-outs, ranks) of the tree_mesh case; the pool and budgets are the
# reference's mesh test's (tests/test_tree_select.py): 512 × 16, 6 and 10
TREE_CASES = (((2, 2), 4), ((2, 2, 2), 4), ((2, 2), 2), ((4, 2), 2), ((4, 1), 1))
TREE_N, TREE_D, TREE_R_LOCAL, TREE_R_FINAL = 512, 16, 6, 10
TREE_SHARDS = 4
FAMILIES = {"dense": "qwen3-1.7b", "moe": "moonshot-v1-16b-a3b",
            "griffin": "recurrentgemma-9b", "xlstm": "xlstm-1.3b"}
B, T = 4, 8
# The extract_mesh case: tests/test_torch_distributed.py's small dense
# config (fp32 compute) and its ragged pool of 19 docs in batches of 4,
# whose plan pads 5 batches to 8 over four shards; the composition pool is
# the whole stream, 40 docs over 4 shards.
EXTRACT_CFG = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
                   n_kv_heads=2, d_ff=64, vocab_size=128, logit_chunk=16)
EXTRACT_DOCS, EXTRACT_SEQ, EXTRACT_B = 40, 16, 4
EXTRACT_POOL = np.arange(0, EXTRACT_DOCS, 2)[:19]
EXTRACT_RUNS = ((3, True), (3, False), (1, True))  # (megabatch, prefetch)
EXTRACT_FRACTION = 0.2


def _batch(cfg, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)),
            "labels": torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)),
            "weights": torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32))}


def _config(arch: str):
    """The arch's smoke config cut to one pattern period (xLSTM's (7 ×
    mlstm, slstm) period as one cell of each)."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(arch)
    pattern = ("mlstm", "slstm") if "slstm" in cfg.block_pattern else cfg.block_pattern
    return dataclasses.replace(cfg, block_pattern=pattern, n_layers=len(pattern))


def _step(cfg, params, batch, microbatches=1, transform=None):
    """One AdamW step (``transform`` its ``grad_transform``) → (loss,
    {name: grad as the optimizer got it}, updated params, opt state)."""
    import dataclasses

    from repro_torch.optim import adamw, constant
    from repro_torch.train.train_step import make_train_step

    opt = adamw(constant(1e-3))
    seen = {}

    def update(grads, state, params):
        seen.update({k: g.clone() for k, g in grads.items()})  # the update clips in place
        return opt.update(grads, state, params)

    state = opt.init(params)
    step = make_train_step(cfg, dataclasses.replace(opt, update=update),
                           microbatches=microbatches, grad_transform=transform)
    params, state, metrics = step(params, state, batch)
    return metrics["loss"], seen, params, state


def _place(tree: dict, specs: dict, mesh) -> dict:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import to_placements

    return {k: distribute_tensor(v, mesh, to_placements(specs[k], mesh), src_data_rank=None)
            for k, v in tree.items()}


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(a, b) -> float:
    a, b = _full(a).double(), _full(b).double()
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _sharded_vs_plain(mesh, arch: str, microbatches: int = 1) -> dict:
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import init_params

    cfg = _config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg, 1)
    loss0, g0, p0, _ = _step(cfg, copy.deepcopy(params), batch, microbatches)
    dp = _place(params, shd.param_specs(params, mesh), mesh)
    db = _place(batch, shd.batch_specs(mesh, batch), mesh)
    loss1, g1, p1, s1 = _step(cfg, dp, db, microbatches)
    placed = all(tuple(s1.inner["m"][k].placements) == tuple(dp[k].placements) for k in dp)
    return {"loss": float(loss0), "loss_sharded": float(_full(loss1)),
            "loss_rel": abs(float(_full(loss1)) - float(loss0)) / abs(float(loss0)),
            "grad_rel": {k: _rel(g1[k], g0[k]) for k in g0},
            "param_rel": {k: _rel(p1[k], p0[k]) for k in p0},
            "bitwise": bool(float(_full(loss1)) == float(loss0)
                            and all(torch.equal(_full(g1[k]), g0[k]) for k in g0)
                            and all(torch.equal(_full(p1[k]), p0[k]) for k in p0)),
            "moments_placed_like_params": placed}


def _compressed_vs_plain(mesh) -> dict:
    """The dense step with ``grad_transform`` = the group form of
    ``compressed_psum`` over ``data``: each replica's gradient on the int8
    wire, against the list form over the replicas' gradients computed
    without a mesh, each on its own rows.  The weights are ones, so a
    replica's gradient is the gradient of its rows' mean loss, as under
    the reference's ``shard_map``.  Also how far the result lies from the
    int8 wire over the reduced gradient (the mean first, then quantized)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.models import init_params, loss_fn

    names = mesh.mesh_dim_names

    def compressed(grads):  # the model split gathered, then the wire over data
        out = {}
        for k, g in grads.items():
            whole = g.redistribute(g.device_mesh, [p if n == "data" else Replicate()
                                                   for n, p in zip(names, g.placements)])
            mean = compressed_psum(whole.to_local(), (g.device_mesh, "data"))
            out[k] = DTensor.from_local(mean, g.device_mesh, [Replicate()] * len(names),
                                        run_check=False)
        return out

    cfg = _config(FAMILIES["dense"])
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = {**_batch(cfg, 1), "weights": torch.ones(B)}

    def grads(rows):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total, _ = loss_fn(leaves, cfg, {k: v[rows] for k, v in batch.items()})
        return total, dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))

    n = mesh.size(names.index("data"))
    per = [grads(slice(r * B // n, (r + 1) * B // n))[1] for r in range(n)]
    twin = {k: compressed_psum([g[k] for g in per]) for k in params}
    loss0, whole = grads(slice(None))
    reduced_first = {k: compressed_psum([whole[k]] * n) for k in params}
    specs = shd.param_specs(params, mesh)
    db = _place(batch, shd.batch_specs(mesh, batch), mesh)
    # each step updates its placed copy of the parameters in place
    loss1, got, _, _ = _step(cfg, _place(copy.deepcopy(params), specs, mesh), db,
                             transform=compressed)
    # a hook that returns the replicas' gradients as it got them: the step
    # reduces them itself
    _, kept, _, _ = _step(cfg, _place(copy.deepcopy(params), specs, mesh), db,
                          transform=lambda g: g)
    return {"loss_rel": abs(float(_full(loss1)) - float(loss0)) / abs(float(loss0)),
            "identity_rel": {k: _rel(kept[k], whole[k]) for k in params},
            "grad_rel": {k: _rel(got[k], twin[k]) for k in params},
            "reduced_first_rel": {k: _rel(got[k], reduced_first[k]) for k in params},
            "raw_grad_rel": max(_rel(got[k], whole[k]) for k in params)}


def _bitwise_serving(mesh) -> dict:
    """Select and decode steps of the dense smoke config on ``mesh``
    against the unsharded ones."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import init_params, init_serve_state
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train.train_step import make_select_step

    cfg = _config(FAMILIES["dense"])
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg, 2)
    batch.pop("weights")
    sel = make_select_step(cfg, proxy_impl="torch")
    f0 = sel(params, batch)
    f1 = sel(_place(params, shd.param_specs(params, mesh), mesh),
             _place(batch, shd.batch_specs(mesh, batch), mesh))
    step = make_serve_step(cfg)
    sp = _place(params, shd.serve_param_specs(params, mesh), mesh)
    st0 = init_serve_state(cfg, B, T, "cpu")
    st1 = init_serve_state(cfg, B, T, "cpu", mesh=mesh)
    ok = True
    for t in range(T):
        tok = {"tokens": batch["tokens"][:, t:t + 1]}
        l0, st0 = step(params, st0, tok)
        l1, st1 = step(sp, st1, _place(tok, shd.batch_specs(mesh, tok), mesh))
        ok &= torch.equal(_full(l1), l0)
    return {"select_bitwise": bool(torch.equal(_full(f1), f0)), "decode_bitwise": bool(ok)}


def _checkpoint(mesh, out: str) -> dict:
    """Save a placed tree on ``mesh``, restore it onto a 4×1 mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant

    cfg = _config(FAMILIES["dense"])
    params = init_params(cfg, torch.Generator().manual_seed(3))
    dp = _place(params, shd.param_specs(params, mesh), mesh)
    state = adamw(constant(1e-3)).init(dp)
    for k in state.inner["m"]:
        state.inner["m"][k].add_(dp[k])
    ckpt = CheckpointManager(os.path.join(out, "ckpt"))
    ckpt.save(7, {"params": dp, "opt": state})
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    specs = shd.param_specs(params, mesh41)
    lay = {k: (mesh41, shd.to_placements(s, mesh41)) for k, s in specs.items()}
    empty = {k: torch.empty_like(v) for k, v in params.items()}
    template = {"params": empty, "opt": type(state)(0, {"m": empty, "v": empty})}
    tree, _ = ckpt.restore(template, shardings={"params": lay,
                                                "opt": type(state)((), {"m": lay, "v": lay})})
    equal = all(torch.equal(tree["params"][k].full_tensor(), params[k]) for k in params)
    equal &= all(torch.equal(tree["opt"].inner["m"][k].full_tensor(), params[k]) for k in params)
    placed = all(tuple(tree["params"][k].placements) == lay[k][1] for k in params)
    return {"restored_equal": bool(equal), "restored_placed": bool(placed),
            "step": int(tree["opt"].step)}


def sharded_step(out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import model

    rank = dist.get_rank()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res: dict = {"seconds": {}}
    # fp32 products: the shards' partial sums then differ from one product
    # by fp32 rounding alone (bf16 ones round each partial sum; the (1, 1)
    # mesh below holds the bf16 step bit for bit)
    model.COMPUTE_DTYPE = torch.float32
    for fam, arch in FAMILIES.items():
        t0 = time.time()
        res[fam] = _sharded_vs_plain(mesh, arch)
        res["seconds"][fam] = time.time() - t0

    res["compressed"] = _compressed_vs_plain(mesh)
    model.COMPUTE_DTYPE = torch.bfloat16
    res["checkpoint"] = _checkpoint(mesh, out)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        # a group of one: a (1, 1) mesh holds the unsharded step bit for bit
        store = os.path.abspath(os.path.join(out, "one"))
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
        one = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        res["one"] = {fam: _sharded_vs_plain(one, arch, microbatches=2 if fam == "dense" else 1)
                      for fam, arch in FAMILIES.items()}
        res["one"]["serving"] = _bitwise_serving(one)
        dist.destroy_process_group()
        with open(os.path.join(out, "sharded_step.json"), "w") as f:
            json.dump(res, f, indent=1)


def collectives(out: str) -> None:
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compression import compressed_psum

    rank, world = dist.get_rank(), dist.get_world_size()
    xs = [torch.from_numpy(np.random.RandomState(10 + r).randn(6, 5).astype(np.float32))
          for r in range(world)]
    big = [torch.from_numpy(np.random.RandomState(20 + r).randn(3, 300).astype(np.float32))
           for r in range(world)]
    x, y = xs[rank], big[rank]
    got = {
        "psum_mean": coll.psum_mean({"a": x}, dist.group.WORLD)["a"],
        "reduce_scatter_mean": coll.reduce_scatter_mean(x, dist.group.WORLD),
        "all_gather_params": coll.all_gather_params(
            coll.reduce_scatter_mean(x, dist.group.WORLD), dist.group.WORLD, x.shape[0]),
        "compressed_psum": compressed_psum(y, dist.group.WORLD),
    }
    gathered = [torch.empty_like(t) for t in [got["reduce_scatter_mean"]] * world]
    dist.all_gather(gathered, got["reduce_scatter_mean"])
    if rank == 0:
        got["reduce_scatter_mean_all"] = torch.stack(gathered)
        got["compressed_psum_list"] = compressed_psum(big)
        torch.save(got, os.path.join(out, "collectives.pt"))
    dist.destroy_process_group()


def tree_pool() -> np.ndarray:
    """The seeded clustered (TREE_N, TREE_D) pool: eight centres 5σ apart,
    each point one of them plus 0.3σ noise."""
    rng = np.random.RandomState(0)
    centers = 5.0 * rng.randn(8, TREE_D).astype(np.float32)
    assign = rng.randint(0, 8, TREE_N)
    return (centers[assign] + 0.3 * rng.randn(TREE_N, TREE_D)).astype(np.float32)


def _tree_selections(world: int, feats, res: dict) -> None:
    """Each TREE_CASES tree of ``world`` ranks on both wires: (indices, γ,
    coverage, all_gather_into_tensor calls this rank made); and the leaf
    ids of its ranks through ``leaf_rows``."""
    from repro_torch.core.distributed import leaf_rows, rank_index
    from repro_torch.distributed.tree_select import (
        TreeTopology, split_levels, tree_select_mesh)
    from repro_torch.launch.tree import make_tree_mesh

    gather = dist.all_gather_into_tensor
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return gather(*args, **kwargs)

    for fanouts, ranks in TREE_CASES:
        if ranks != world:
            continue
        mesh = make_tree_mesh(fanouts, device_type="cpu")
        # the gather the re-weighting's partials take, on each rank's leaf ids
        k, _ = split_levels(fanouts, world)
        per_rank = math.prod(fanouts[:k])
        first = rank_index(mesh) * per_rank
        ids = torch.arange(first, first + per_rank, dtype=torch.float32)[:, None]
        groups = [mesh.get_group(ax) for ax in TreeTopology(fanouts).axis_names[k:]]
        res[(fanouts, ranks, "leaf_rows")] = leaf_rows(ids, groups)[:, 0]
        for compress in ("int8", "none"):
            calls[0] = 0
            dist.all_gather_into_tensor = counted
            try:
                sel = tree_select_mesh(feats, mesh, TreeTopology(fanouts), TREE_R_LOCAL,
                                       TREE_R_FINAL, compress=compress)
            finally:
                dist.all_gather_into_tensor = gather
            res[(fanouts, ranks, compress)] = (sel.indices, sel.weights, sel.coverage,
                                               calls[0])


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def tree_mesh(out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.distributed import distributed_select
    from repro_torch.distributed.tree_select import TreeTopology, tree_select_mesh
    from repro_torch.launch.tree import make_tree_mesh

    rank = dist.get_rank()
    feats = torch.from_numpy(tree_pool())
    res: dict = {}
    _tree_selections(dist.get_world_size(), feats, res)
    data = init_device_mesh("cpu", (TREE_SHARDS,), mesh_dim_names=("data",))
    two = distributed_select(feats, data, TREE_R_LOCAL, TREE_R_FINAL)
    res["two_rounds"] = tuple(two)
    cs = CraigSelector(CraigConfig(fraction=0.05, per_class=False), device="cpu")
    sel = cs.select_distributed(feats, data)
    res["select_distributed"] = (sel.indices, sel.weights, sel.coverage, sel.engine)
    topo = TreeTopology((2, 2))
    mesh = make_tree_mesh(topo.fanouts, device_type="cpu")
    res["ragged"] = _error(lambda: tree_select_mesh(
        feats[:TREE_N - 3], mesh, topo, TREE_R_LOCAL, TREE_R_FINAL))
    res["misfit"] = _error(lambda: make_tree_mesh((4, 2), device_type="cpu"))
    dist.destroy_process_group()
    for world in (2, 1):  # smaller groups: ranks 0–1, then rank 0
        if rank < world:
            store = os.path.abspath(os.path.join(out, f"group{world}"))
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world)
            _tree_selections(world, feats, res)
            dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"tree_mesh.{rank}.pt"))


def extract_setup(params_path: str):
    """(select_fn, dataset, params) of the extract_mesh case, fp32 compute:
    the test's parameters (the reference's, converted) where it wrote them,
    else the port's own seeded ones (a run by hand)."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import init_params, model
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.train_step import make_select_step

    model.COMPUTE_DTYPE = torch.float32
    cfg = ModelConfig(**EXTRACT_CFG)
    ds = TokenStream(n_docs=EXTRACT_DOCS, seq_len=EXTRACT_SEQ, vocab_size=cfg.vocab_size)
    params = (torch.load(params_path) if os.path.exists(params_path)
              else init_params(cfg, torch.Generator().manual_seed(1)))
    return make_select_step(cfg, "auto"), ds, params


def _extracts(world: int, select, ds, params, res: dict) -> None:
    """The extract_mesh checks of one group of ``world`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.distributed import make_distributed_extract
    from repro_torch.core.extract import ProxyExtractor

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    s = dist.get_rank()
    gather, calls = dist.all_gather_into_tensor, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return gather(*args, **kwargs)

    for mb, prefetch in EXTRACT_RUNS:
        ex = ProxyExtractor(select, ds, EXTRACT_B, megabatch=mb, prefetch=prefetch, mesh=mesh)
        calls[0] = 0
        dist.all_gather_into_tensor = counted
        try:
            feats = ex.extract(params, EXTRACT_POOL)
        finally:
            dist.all_gather_into_tensor = gather
        plan = ex._plan(len(EXTRACT_POOL))
        own = True
        for lo, m in plan:  # this rank's slice of each dispatch, against the whole's
            whole, mine = ex._assemble(EXTRACT_POOL, lo, m), ex._assemble(
                EXTRACT_POOL, *ex._own(lo, m))
            per = m // world
            own &= all(np.array_equal(mine[k], v[s * per:(s + 1) * per])
                       for k, v in whole.items())
        res[(world, mb, prefetch)] = (feats, calls[0], plan, own)
    # the function form on one whole megabatch of 2·world batches
    fn = make_distributed_extract(select, mesh)
    batches = {k: torch.as_tensor(v)
               for k, v in ex._assemble(EXTRACT_POOL, 0, 2 * world).items()}
    res[(world, "fn")] = fn(params, batches)
    if world > 1:
        res[(world, "ragged")] = _error(
            lambda: fn(params, {k: v[:world + 1] for k, v in batches.items()}))
    bad = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    res[(world, "misnamed")] = (
        _error(lambda: ProxyExtractor(select, ds, EXTRACT_B, mesh=bad)),
        _error(lambda: make_distributed_extract(select, bad)),
        _error(lambda: ProxyExtractor(select, ds, EXTRACT_B, mesh=mesh, axis_name="pool")))
    # one refresh over the group: the extract, then the two rounds
    ex = ProxyExtractor(select, ds, EXTRACT_B, megabatch=3, mesh=mesh)
    feats = ex.extract(params, np.arange(EXTRACT_DOCS))
    sel = CraigSelector(CraigConfig(fraction=EXTRACT_FRACTION, per_class=False),
                        device="cpu").select_distributed(feats, mesh)
    res[(world, "composition")] = (feats, sel.indices, sel.weights, sel.coverage, sel.engine)


def extract_mesh(out: str) -> None:
    rank = dist.get_rank()
    select, ds, params = extract_setup(os.path.join(out, "extract_params.pt"))
    res: dict = {}
    _extracts(dist.get_world_size(), select, ds, params, res)
    dist.destroy_process_group()
    for world in (2, 1):  # smaller groups: ranks 0–1, then rank 0
        if rank < world:
            store = os.path.abspath(os.path.join(out, f"extract{world}"))
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world)
            _extracts(world, select, ds, params, res)
            dist.destroy_process_group()
    torch.save(res, os.path.join(out, f"extract_mesh.{rank}.pt"))


def launch(case: str, out: str, world: int = 4, timeout: float = 240.0) -> None:
    """Run ``case`` in ``world`` processes of this script over gloo on the
    CPU (one torch thread each); raise with the failed rank's output."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([src, os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--case", case,
                               "--out", out], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise RuntimeError(f"rank {r} of {case} exited {p.returncode}:\n{log[-4000:]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", required=True,
                    choices=["sharded_step", "collectives", "tree_mesh", "extract_mesh"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu", choices=["cpu"],
                    help="gloo runs these checks on the CPU")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dist.init_process_group("gloo")
    {"sharded_step": sharded_step, "collectives": collectives,
     "tree_mesh": tree_mesh, "extract_mesh": extract_mesh}[args.case](args.out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main()
