"""The program's spans as the benchmark reads them, at a tiny size on the
CPU: a traced run reports ``data_ms`` and leaves the device's metrics out;
``span_split`` records the program's spans on every thread only in its
``on`` arm."""
import time

import torch

from perfbench import span_split
from perfbench.harness import run_cell


def test_a_traced_run_reports_data_ms(tiny):
    result, _, _ = run_cell(tiny, "tiny.full", 5, 0.3, True, "cpu", time.perf_counter(),
                            log=lambda s: None)
    assert result["correct"]
    assert result["metrics"]["data_ms"]["value"] > 0
    assert result["metrics"]["data_ms"]["unit"] == "ms"
    assert "device_idle" not in result["metrics"]


def test_the_split_records_every_thread_in_its_on_arm(tiny):
    rows = span_split.split(tiny, "tiny.refresh", 5, 0.2, 1, torch.device("cpu"),
                            log=lambda s: None)
    assert [r["arm"] for r in rows] == list(span_split.ARMS)
    assert all(r["steps"] > 0 and r["tokens_per_s"] > 0 for r in rows)
    on = rows[-1]
    assert "readings" not in rows[0] and "readings" not in rows[1]
    for name in ("step", "step.data", "step.forward", "step.backward", "step.optimizer"):
        assert on["threads"][name][0] > 0 and on["threads"][name][1] == 0, name
    for name in ("refresh", "extract", "select", "publish"):
        assert on["threads"][name][0] == 0 and on["threads"][name][1] > 0, name
    # no device on the CPU: host numbers only
    assert set(on["readings"]) == {"data_ms", "step_idle_ms"}
    assert all(label.split("/")[-1].startswith("step") for label, _ in on["gaps"])
