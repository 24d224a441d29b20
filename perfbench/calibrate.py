"""Readings that the comparison's limits are set from, on the card.

    python3 perfbench/calibrate.py --workload qwen2-7b.refresh_every_epoch \
        --seeds 11 12 13 --seconds 1 [--plant half_batch] [--control-seeds 21 22 23]

For each seed of ``--seeds`` it runs the cell as the benchmark does (a
short window), with the fault ``--plant`` beneath the timed path if one
is named, and prints the numbers compared.  For each seed of
``--control-seeds`` it prints the control's numbers: the reference put in
the program's place and computed in fp8 (``reference.model.Matmul``),
against the reference in fp32, on the cell's own sizes: three training
steps, proxy features at the seeded weights (the sampled documents) and
after those steps (the whole pool), and after them one step on a batch
weighted as an installed coreset weights it (γ drawn from the seed).
One JSON object a line on standard output, copied to
``chiprun_out/calibrate/<cell>.jsonl`` when that directory can be made.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(spec, name: str, seed: int, device) -> dict:
    import numpy as np
    import torch

    from perfbench import check as ck
    from perfbench import weights as W
    from perfbench.corpus import Corpus, derive_seed
    from perfbench.model_shape import Shape
    from perfbench.reference import model as rm
    from perfbench.reference.training import adamw_steps, loss_and_grad_norms
    from perfbench.runners.train import change_norms, pool_features, sample_docs, tensors

    cell = spec.cell(name)
    mix, shape = cell.traffic, Shape.from_config(cell.config_name, cell.config)
    rm.no_tf32()
    corpus = Corpus(mix["docs"], mix["seq_len"], shape.vocab_size, mix["n_topics"],
                    derive_seed(seed, "corpus"))
    rng = np.random.default_rng(derive_seed(seed, "control steps"))
    docs = rng.choice(mix["docs"], size=(mix["check_steps"] + 1) * mix["batch"], replace=False)
    docs = docs.reshape(mix["check_steps"] + 1, mix["batch"])
    batches = []
    for idx in docs[:-1]:
        t, lab = tensors(corpus, idx, device)
        batches.append((t, lab, torch.ones(len(idx), device=device)))
    gam = rng.integers(1, 10, size=mix["batch"]).astype(np.float64)
    wtok, wlab = tensors(corpus, docs[-1], device)
    wts = torch.as_tensor(gam * len(gam) / gam.sum(), dtype=torch.float32, device=device)
    tok, lab = tensors(corpus, sample_docs(mix, seed), device)
    f32, f8 = rm.Matmul("fp32"), rm.Matmul("fp8")
    rows, out = mix["reference_rows"], {}
    p = W.make_params(shape, seed, device)
    if mix["use_craig"]:
        out["feat0_gap"] = ck.row_gap(rm.proxy_features(p, shape, tok, lab, f8, rows),
                                      rm.proxy_features(p, shape, tok, lab, f32, rows))
    r32 = adamw_steps(p, shape, batches, mix["optimizer"], f32, rows)
    c32 = change_norms(shape, seed, p, device)
    if mix["use_craig"]:
        pool = np.arange(mix["docs"])
        out["featw_gap"] = ck.row_gap(pool_features(p, shape, corpus, pool, f8, rows, device),
                                      pool_features(p, shape, corpus, pool, f32, rows, device))
        w8 = loss_and_grad_norms(p, shape, wtok, wlab, wts, f8, rows)
        w32 = loss_and_grad_norms(p, shape, wtok, wlab, wts, f32, rows)
        out["wstep_loss_gap"] = abs(w8["loss"] - w32["loss"]) / abs(w32["loss"])
        out["wstep_grad_gap"] = ck.norm_gap(w8["norms"], w32["norms"])
    del p
    gc.collect()
    p = W.make_params(shape, seed, device)
    r8 = adamw_steps(p, shape, batches, mix["optimizer"], f8, rows)
    c8 = change_norms(shape, seed, p, device)
    del p
    gc.collect()
    gaps = ck.step_gaps(r8["losses"], r32["losses"])
    out["loss1_gap"] = gaps[0]
    out["grad1_gap"] = ck.norm_gap(r8["grad1"], r32["grad1"])
    out["change3_gap"] = ck.norm_gap(c8, c32, keep=ck.moving_leaves(r32["grad1"]))
    return out, {"loss_gaps": gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--plant", default=None)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench.harness import run_cell
    from perfbench.spec import Spec

    spec = Spec(ROOT / "BENCHMARK.json")
    out_dir = ROOT / "chiprun_out" / "calibrate"
    out_dir.mkdir(parents=True, exist_ok=True)
    sink = open(out_dir / f"{args.workload}.jsonl", "a")

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    for seed in args.seeds:
        t0 = time.perf_counter()
        result, _, info = run_cell(spec, args.workload, seed, args.seconds, False,
                                   args.device, time.perf_counter(), plant=args.plant,
                                   log=lambda s: print(s, file=sys.stderr, flush=True))
        emit({"kind": "fault" if args.plant else "program", "plant": args.plant, "seed": seed,
              "correct": result["correct"], **info,
              "metrics": result["metrics"], "peak_bytes": result["device"]["memory_peak_bytes"],
              "seconds": time.perf_counter() - t0})
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        numbers, info = control_numbers(spec, args.workload, seed, torch.device(args.device))
        emit({"kind": "control", "seed": seed, "numbers": numbers, **info,
              "seconds": time.perf_counter() - t0})
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
