"""Multi-process entry point of hierarchical tree selection.

Port of ``repro.launch.tree``.  Process 0 hosts a
``torch.distributed.TCPStore`` at ``--coordinator host:port``; the others
connect to it, and the store is the candidate wire of
``distributed.process_tree.tree_select_processes`` (one process per leaf)
over a synthetic clustered pool.  One line per process::

    PYTHONPATH=src python -m repro_torch.launch.tree \\
        --coordinator 127.0.0.1:8476 --num-processes 4 --process-id $i \\
        --fanouts 2,2 --n 4096 --d 32 --r-local 16 --r-final 32 --device cpu

Process ``pid`` computes on ``cuda:{pid % device_count}`` (``--device
cuda``, the default; on one card every leaf shares ``cuda:0``) or on the
CPU (``--device cpu``).  A fault plan in ``$REPRO_FAULT_PLAN`` is installed
first.  Every process prints one ``TREE_SELECT_RESULT {json}`` line.
``--driver mesh`` (one program over a multi-process mesh) needs NCCL
collectives across cards and raises.
"""
from __future__ import annotations

import argparse
import datetime
import json
import time

import numpy as np
import torch

__all__ = ["initialize_distributed", "main"]

_MULTI_GPU_ITEM = "ROADMAP.md queue 1, 'Model parallelism and multi-GPU meshes'"


def initialize_distributed(
    coordinator_address: str, num_processes: int, process_id: int,
    timeout_s: float = 300.0,
):
    """The wire of the process tree: a ``TCPStore`` hosted by process 0 at
    ``coordinator_address`` (``host:port``), joined by the others; waits
    until all ``num_processes`` have connected."""
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"--coordinator {coordinator_address!r} is not host:port"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"--process-id {process_id} is outside [0, {num_processes})"
        )
    return torch.distributed.TCPStore(
        host, int(port), num_processes, process_id == 0,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _synthetic_pool(n: int, d: int, seed: int) -> np.ndarray:
    """Deterministic clustered (n, d) fp32 pool: eight Gaussian clusters,
    identical in every process for one seed, so each process slices its
    own shard without any I/O."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 5.0
    assign = rng.integers(0, 8, size=n)
    noise = rng.normal(size=(n, d)).astype(np.float32) * 0.3
    return (centers[assign] + noise).astype(np.float32)


def _leaf_device(device: str, pid: int) -> torch.device:
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", pid % torch.cuda.device_count())
    return dev


def _exit_barrier(store, pid: int, survivors: int, deadline_s: float) -> None:
    """Process 0 hosts the store, so it leaves last: every survivor checks
    in, and process 0 waits (up to ``deadline_s``) until all have."""
    store.add("tree/exit", 1)
    if pid != 0:
        return
    end = time.monotonic() + deadline_s
    while store.add("tree/exit", 0) < survivors and time.monotonic() < end:
        time.sleep(0.05)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", required=True,
                   help="host:port of the store process 0 hosts")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--fanouts", default="2",
                   help="comma-separated leaf→root fan-outs, e.g. 4,2")
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--r-local", type=int, default=8)
    p.add_argument("--r-final", type=int, default=10)
    p.add_argument("--compress", default="int8", choices=("int8", "none"))
    p.add_argument("--driver", default="processes",
                   choices=("processes", "mesh"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (process pid on cuda:{pid % cards}) or 'cpu'")
    # liveness and degradation (processes driver)
    p.add_argument("--level-deadline-s", type=float, default=None,
                   help="per-level wait before a child subtree is declared "
                        "dead (default: $REPRO_KV_TIMEOUT_MS, 300 s)")
    p.add_argument("--min-quorum", type=float, default=1.0,
                   help="minimum surviving-leaf fraction; below it the "
                        "selection fails instead of degrading")
    p.add_argument("--heartbeat-interval-s", type=float, default=0.5)
    p.add_argument("--heartbeat-grace-s", type=float, default=5.0)
    args = p.parse_args(argv)

    # a chaos run arms per-process faults through $REPRO_FAULT_PLAN, before
    # any selection work, so an injected kill hits the intended site
    from repro_torch.faults import install_from_env

    install_from_env()

    if args.driver == "mesh":
        raise NotImplementedError(
            "--driver mesh runs one program over a multi-process mesh, which "
            f"needs NCCL collectives across cards ({_MULTI_GPU_ITEM}); use "
            "the processes driver, or tree_select_mesh in one process"
        )

    from repro_torch.distributed.process_tree import HealthConfig, tree_select_processes
    from repro_torch.distributed.tree_select import TreeTopology

    health = HealthConfig(
        level_deadline_s=args.level_deadline_s,
        min_quorum=args.min_quorum,
        heartbeat_interval_s=args.heartbeat_interval_s,
        heartbeat_grace_s=args.heartbeat_grace_s,
    )
    pid, nproc = args.process_id, args.num_processes
    dev = _leaf_device(args.device, pid)
    store = initialize_distributed(args.coordinator, nproc, pid,
                                   timeout_s=health.deadline_s())
    topology = TreeTopology(tuple(int(f) for f in args.fanouts.split(",")))
    feats = _synthetic_pool(args.n, args.d, args.seed)
    shard = np.array_split(np.arange(args.n), nproc)[pid]
    sel = tree_select_processes(
        torch.from_numpy(feats[shard]).to(dev), topology, args.r_local,
        args.r_final, store=store, pid=pid, nproc=nproc,
        compress=args.compress, health=health,
    )

    record = {
        "process": pid,
        "driver": args.driver,
        "device": str(dev),
        "fanouts": list(topology.fanouts),
        "compress": args.compress,
        "indices": sel.indices.cpu().tolist(),
        "r_final": int(sel.indices.shape[0]),
        "weight_sum": float(sel.weights.sum()),
        "weights": sel.weights.cpu().tolist(),
        "coverage": float(sel.coverage),
        "wire_bytes": sel.wire["gathered_feature_bytes"],
        "wire_reduction": round(sel.wire["reduction"], 3),
        "health": sel.health,
    }
    print("TREE_SELECT_RESULT " + json.dumps(record), flush=True)
    survivors = nproc - len(sel.health["missing_pids"])
    _exit_barrier(store, pid, survivors, health.deadline_s())


if __name__ == "__main__":
    main()
