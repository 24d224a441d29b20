"""One run of one cell: the mix's runner, then the check and the metrics.

The cell's traffic mix names its runner (``"runner"``), a module
``runners/<name>.py`` found by name as every other file of a cell is.  The
runner sets up the program, drives the measured window, frees the
program's state and runs the plain reference; it returns an ``Outcome``:
the object the metric readers read, the numbers the check compares, and
the counts of the result line.  This module judges those numbers against
the cell's limits (``check.judge``), reads the cell's metrics and
assembles the result line.  A later kind of cell (selection alone, the
tree, serving) is a new runner, mix and metric files, with no edit here.
"""
from __future__ import annotations

import torch

from perfbench import check as ck
from perfbench.spec import Spec

__all__ = ["run_cell"]


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, plant: str | None = None, log=print) -> tuple[dict, list, dict]:
    """Runs cell ``name`` once.  Returns (the result object, the check's
    lines, the runner's readings shown but not compared, with every number
    of the check under ``"numbers"``).  ``plant`` breaks the timed path
    (tests, calibration: one of the runner's ``PLANTS``)."""
    cell = spec.cell(name)
    device = torch.device(device)
    out = cell.runner.run(cell, seed, seconds, trace, device, t_start, plant=plant, log=log)
    correct, checked = ck.judge(dict(sorted(out.numbers.items())), cell.limits)
    shown = {**out.shown, "not compared": {k: v for k, v in out.numbers.items()
                                           if k not in checked}}
    log(f"shown: {shown!r}")

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = m.read(out.run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": int(out.run.peak_bytes)}
    result = {"correct": bool(correct and out.failed == 0), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    summary = out.run.trace
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        ops_ = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[n, v[0]] for n, v in ops_],
                               "idle_gaps": [[n, s] for n, s in summary.gaps]}
    result["check"] = checked
    return result, ck.format_lines(checked), {**out.shown, "numbers": dict(out.numbers)}
