"""The port stands alone: no JAX and no ``repro`` inside ``repro_torch`` or
``chip_smoke.py``, and nothing silently runs on the CPU when CUDA is asked
for on a machine without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.kernels import ops

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.core.craig, repro_torch.convert, "
        "repro_torch.examples.quickstart, repro_torch.optim\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for CPU-only machines")
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        CraigSelector(CraigConfig(), device="cuda").select(x)
    with pytest.raises(RuntimeError, match="cuda"):
        CraigSelector(CraigConfig())  # the default device is the card


def test_cuda_kernels_refuse_cpu_tensors():
    x = torch.randn(9, 3)
    sq = (x * x).sum(1)
    cur = torch.zeros(9)
    chosen = torch.zeros(9, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fl_gains_argmax(x, x, cur, sq, sq, 1.0, chosen, gains_impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fl_gains(x, x, cur, sq, sq, 1.0, gains_impl="cuda")
    from repro_torch.kernels import fl_gains as kfl

    with pytest.raises(ValueError, match="CUDA"):
        kfl.fl_gains_argmax_cuda(x, x, cur, sq, sq, chosen)
    assert ops.LAUNCHES == {"fl_gains": 0, "fl_gains_argmax": 0}


def test_auto_dispatch_takes_the_plain_twin_only_on_the_cpu():
    assert ops.resolve_impl("auto", torch.device("cpu")) == "torch"
    assert ops.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert ops.resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError):
        ops.resolve_impl("cuda", torch.device("cpu"))
