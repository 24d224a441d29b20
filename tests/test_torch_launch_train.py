"""``repro_torch.launch.train`` on the CPU: the reference launcher's options
at a smoke config, one dense, one MoE and the hybrid architecture — a few steps with a
finite loss and one CRAIG selection (the pool is one epoch of 4 steps, so
only the epoch-0 refresh runs)."""
import math

import pytest
import torch

from repro_torch.launch import train
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker


@pytest.mark.parametrize("arch", ["qwen2-7b", "moonshot-v1-16b-a3b", "recurrentgemma-9b"])
def test_smoke_training_runs_on_the_cpu(arch, capsys):
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
                      "--batch", "4", "--seq", "16", "--docs", "16"])
    assert len(out["losses"]) == 4 and all(math.isfinite(v) for v in out["losses"])
    assert out["selections"] == 1
    assert f"arch={arch} (smoke)" in capsys.readouterr().out


def test_options_are_the_reference_launchers():
    args = train.parse_args(["--arch", "dbrx-132b"])
    assert vars(args) == {
        "arch": "dbrx-132b", "smoke": False, "steps": 50, "batch": 8, "seq": 64, "docs": 256,
        "lr": 3e-4, "microbatches": 1, "craig_fraction": 0.5, "no_craig": False,
        "select_every": 1, "ckpt": None, "device": "cuda"}
    assert train.parse_args(["--arch", "xlstm-1.3b"]).arch == "xlstm-1.3b"  # ported
    with pytest.raises(SystemExit):
        train.parse_args(["--arch", "mamba-2.8b"])  # not registered: not a choice
    with pytest.raises(ValueError, match="codebook heads"):
        train.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu"])


def test_the_launcher_raises_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for CPU-only machines")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])  # default --device
