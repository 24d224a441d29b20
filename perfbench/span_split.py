"""Where a cell's steps and refreshes spend their time, by the program's spans.

    python3 perfbench/span_split.py --workload qwen2-7b.full_data --seed 7 \\
        --seconds 20 --repeats 3 --out chiprun_out/split.jsonl

from the root of a checkout.  Sets the cell up as its runner does
(``runners/train.py``: corpus and weights from ``--seed``, one ``Trainer``
observed by the runner's ``Probe``, the first epoch), then measures
windows of whole epochs, each ending at the next install as the runner's
does, under ``torch.profiler`` in turns of three arms:

  bench  as the benchmark's traced run records: the training thread's
         events only, the program's spans off;
  off    every thread's events (``profile_all_threads``), spans off;
  on     every thread's events, the program's spans on.

The arms' window tokens/s give what recording costs.  Each window prints
one line and appends one JSON object to ``--out``: tokens/s, steps, the
device's busy seconds and idle share, ``ce_proxy``'s seconds and
launches, the ten costliest device operations, the allocator's retries
and device allocations over the window, and for ``on`` the readings of
``program_trace`` (the six per-layer numbers and the share of device
time the spans account for), the device seconds and median host
milliseconds by span, the spans seen on the training thread and on
others, the unattributed kernels and the labelled idle gaps.  No reference check and no result line: this is
a tool for reading a cell, not a run of the benchmark.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARMS = ("bench", "off", "on")
ALLOC = ("num_alloc_retries", "num_device_alloc")


def _setup(spec, name: str, seed: int, device, log):
    """The cell's trainer after its first epoch, as the runner builds it."""
    import torch

    from perfbench import weights as W
    from perfbench.corpus import Corpus, derive_seed
    from perfbench.model_shape import Shape
    from perfbench.runners import train as rt
    from repro_torch.train import Trainer

    cell = spec.cell(name)
    mix, shape = cell.traffic, Shape.from_config(cell.config_name, cell.config)
    for line in rt.card_lines(device):
        log(line)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    corpus = Corpus(mix["docs"], mix["seq_len"], shape.vocab_size, mix["n_topics"],
                    derive_seed(seed, "corpus"))
    params = W.make_params(shape, seed, device)
    probe = rt.Probe(tracing=True)
    trainer = Trainer(rt.port_config(shape), rt._trainer_config(mix, seed), corpus,
                      probe.optimizer(rt._optimizer(mix)), lambda: params, device=device)
    del params
    probe.attach(trainer)
    trainer.run(mix["docs"] // mix["batch"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return trainer, mix


def _window(trainer, mix: dict, arm: str, seconds: float, device) -> dict:
    """One profiled window of whole epochs; returns its numbers."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    from perfbench import program_trace as pt
    from repro_torch import spans

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kw = {} if arm == "bench" else {
        "experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    prof = torch.profiler.profile(activities=acts, **kw)
    alloc0 = torch.cuda.memory_stats(device) if cuda else {}
    n_log = len(trainer.metrics_log)
    spans.enable(arm == "on")
    prof.start()
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench.window"):
        while True:
            trainer.run(1)
            if trainer.sampler.step_in_epoch == 0 and time.perf_counter() - t0 >= seconds:
                break
        if mix["use_craig"]:
            trainer.refresher.wait()
        if cuda:
            torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof.stop()
    spans.enable(False)
    alloc1 = torch.cuda.memory_stats(device) if cuda else {}
    log = trainer.metrics_log[n_log:]
    steps = [m for m in log if m["event"] == "step"]
    installs = [m for m in log if m["event"] == "craig_refresh"]
    out = {"arm": arm, "window_s": t1 - t0, "steps": len(steps),
           "tokens_per_s": len(steps) * mix["batch"] * mix["seq_len"] / (t1 - t0),
           "step_ms": 1000.0 * statistics.median(m["time_s"] for m in steps),
           "alloc": {k: alloc1.get(k, 0) - alloc0.get(k, 0) for k in ALLOC}}
    if installs:
        out["extract_s"] = statistics.mean(m["extract_time_s"] for m in installs)
    st = pt.summarize(prof)
    out["busy_s"] = st.base.busy_s
    out["idle_pct"] = 100.0 * (st.base.window_s - st.base.busy_s) / st.base.window_s
    out["ce_proxy"] = st.base.time_of("ce_proxy")
    out["device_ops"] = sorted(st.base.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    if arm == "on":
        out["readings"] = pt.readings(st)
        incl = st.inclusive_s()
        by, host, seen = {}, {}, {}
        for i, s in enumerate(st.spans):
            by[s.name] = by.get(s.name, 0.0) + st.device_s[i]
            host.setdefault(s.name, []).append((s.end - s.start) / 1e6)
            seen.setdefault(s.name, [0, 0])[s.thread != st.main] += 1
        out["device_s"] = by
        out["host_ms"] = {k: statistics.median(v) for k, v in host.items()}
        out["threads"] = seen  # [on the training thread, on others]
        out["extract_device_s"] = [incl[i] for i in st.inside("extract")]
        out["unattributed"] = sorted(st.unattributed.items(), key=lambda kv: -kv[1][0])[:10]
        out["gaps"] = st.gaps
    else:
        out["gaps"] = st.base.gaps
    del prof
    return out


def split(spec, name: str, seed: int, seconds: float, repeats: int, device, log=print,
          out: Path | None = None) -> list[dict]:
    """Sets ``name`` up and measures ``repeats`` turns of the three arms,
    the order rotated each turn."""
    trainer, mix = _setup(spec, name, seed, device, log)
    rows = []
    for r in range(repeats):
        for arm in ARMS[r % 3:] + ARMS[:r % 3]:
            row = {"workload": name, "seed": seed, "turn": r,
                   **_window(trainer, mix, arm, seconds, device)}
            rows.append(row)
            log(json.dumps({k: row[k] for k in ("workload", "turn", "arm", "tokens_per_s",
                                                 "steps", "idle_pct", "ce_proxy", "alloc")}
                           | {"readings": row.get("readings")}))
            if out is not None:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    trainer.refresher.wait()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench.spec import Spec

    if not torch.cuda.is_available():
        print("no CUDA device: the split reads the card's trace", file=sys.stderr)
        return 2
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
    split(Spec(ROOT / "BENCHMARK.json"), args.workload, args.seed, args.seconds, args.repeats,
          torch.device("cuda"), log=lambda s: print(s, flush=True), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
