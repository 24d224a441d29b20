"""The port stands alone: no JAX and no ``repro`` inside ``repro_torch``,
``chip_smoke.py`` or ``chip_variants.py``, and nothing silently runs on the CPU when CUDA is asked
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
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_variants.py"]
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
        "repro_torch.examples.quickstart, repro_torch.optim, repro_torch.models, "
        "repro_torch.configs, repro_torch.train, repro_torch.core.proxy, "
        "repro_torch.core.extract, repro_torch.core.refresh, repro_torch.checkpoint, "
        "repro_torch.data, repro_torch.faults, repro_torch.kernels.ce_proxy, "
        "repro_torch.examples.lm_coreset_training, repro_torch.core.engines.sparse, "
        "repro_torch.core.engines.streaming, repro_torch.kernels.topk_sim, "
        "repro_torch.kernels.pairwise_l2, repro_torch.serve, repro_torch.launch.serve\n"
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
    assert ops.LAUNCHES == {"fl_gains": 0, "fl_gains_argmax": 0, "ce_proxy": 0,
                            "topk_sim": 0, "pairwise_l2": 0, "fl_replay": 0}


def test_ce_proxy_kernel_refuses_cpu_tensors():
    from repro_torch.kernels import ce_proxy as kce

    h, w = torch.randn(5, 8), torch.randn(11, 8)
    y = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ce_proxy(h, w, y, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kce.ce_proxy_cuda(h, w, y, 11)
    assert ops.LAUNCHES["ce_proxy"] == 0


def test_lm_entry_points_raise_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for CPU-only machines")
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.examples import lm_coreset_training as ex
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config("qwen3-1.7b")
    ds = TokenStream(n_docs=8, seq_len=4, vocab_size=cfg.vocab_size)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainerConfig(), ds, adamw(constant(1e-3)), dict)  # default: the card
    with pytest.raises(RuntimeError, match="cuda"):
        ex.main(["--steps", "1"])  # default --device cuda
    with pytest.raises(RuntimeError):
        init_params(cfg, torch.Generator(device="cuda"))


def test_auto_dispatch_takes_the_plain_twin_only_on_the_cpu():
    from repro_torch.kernels import ce_proxy as kce

    h, w = torch.randn(5, 8), torch.randn(11, 8)
    y = torch.arange(5)
    torch.testing.assert_close(ops.ce_proxy(h, w, y, impl="auto"),
                               kce.ce_proxy_torch(h, w, y, 11, torch.float32))
    assert ops.resolve_impl("auto", torch.device("cpu")) == "torch"
    assert ops.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert ops.resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError):
        ops.resolve_impl("cuda", torch.device("cpu"))


def test_streaming_entry_points_raise_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for CPU-only machines")
    from repro_torch.core.engines import StreamingSelector
    from repro_torch.launch import serve
    from repro_torch.serve import CoresetService

    with pytest.raises(RuntimeError, match="cuda"):
        CoresetService(4, 3)  # the default device is the card
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingSelector(4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--coreset"])  # default --device cuda
