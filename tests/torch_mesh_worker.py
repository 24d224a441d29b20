"""One rank of the port's multi-process mesh checks, over gloo on the CPU.

Run by ``tests/test_torch_sharded_step.py`` and
``tests/test_torch_collectives.py`` (four processes each), or by hand::

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
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

FAMILIES = {"dense": "qwen3-1.7b", "moe": "moonshot-v1-16b-a3b",
            "griffin": "recurrentgemma-9b", "xlstm": "xlstm-1.3b"}
B, T = 4, 8


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
    ap.add_argument("--case", choices=["sharded_step", "collectives"], required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu", choices=["cpu"],
                    help="gloo runs these checks on the CPU")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    dist.init_process_group("gloo")
    {"sharded_step": sharded_step, "collectives": collectives}[args.case](args.out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main()
