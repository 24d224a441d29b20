"""``correct`` at a tiny size on the CPU: a sound run passes; the control
(the reference in fp8 in the program's place) and each fault the cell can
have, planted beneath the timed path, fail."""
import time

import pytest
import torch

from perfbench.calibrate import control_numbers
from perfbench.check import judge
from perfbench.harness import run_cell
from perfbench.runners.train import PLANTS


def _run(spec, cell, seed, plant=None):
    result, lines, _ = run_cell(spec, cell, seed, 0.3, False, "cpu", time.perf_counter(),
                             plant=plant, log=lambda s: None)
    return result, lines


@pytest.mark.parametrize("cell", ["tiny.refresh", "tiny.full"])
def test_a_sound_run_is_correct(tiny, cell):
    result, lines = _run(tiny, cell, 4)
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"
    assert len(lines) == len(result["check"])
    names = {m for m in result["metrics"]}
    assert {"train_tokens_per_s", "peak_mem_gb", "setup_s"} <= names
    assert ("coreset_s" in names) == (cell == "tiny.refresh")


def test_a_traced_run_reports_the_per_layer_metrics(tiny):
    result, _, _ = run_cell(tiny, "tiny.refresh", 5, 0.3, True, "cpu", time.perf_counter(),
                         log=lambda s: None)
    assert result["correct"]
    assert {"step_ms", "mfu", "extract_s", "select_s", "install_stall_s",
            "window_steps"} <= set(result["metrics"])
    # no device work on the CPU: the device readers leave their metrics out
    assert "device_idle" not in result["metrics"]
    assert "ce_proxy_roofline" not in result["metrics"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("plant", PLANTS)
def test_each_fault_is_caught(tiny, plant):
    cell = "tiny.full" if plant == "half_batch" else "tiny.refresh"
    result, _ = _run(tiny, cell, 4, plant)
    assert not result["correct"], (plant, result["check"])


def test_the_control_is_caught(tiny):
    numbers, _ = control_numbers(tiny, "tiny.refresh", 4, torch.device("cpu"))
    correct, checked = judge(numbers, tiny.cell("tiny.refresh").limits)
    assert not correct, checked
