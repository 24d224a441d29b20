"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` begins with ``repro``),
and the entry refuses to run without a card."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.spec import HERE

ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_file_imports_jax_or_repro(path):
    for name in _imports(HERE / path):
        assert name.split(".")[0] not in FORBIDDEN, name


def test_the_check_compares_whole_top_level_names():
    sys.path.insert(0, str(HERE))
    try:
        import run as entry
    finally:
        sys.path.remove(str(HERE))
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = object()
        sys.modules["reproduce.x"] = object()
        assert not [m for m in entry.loaded_forbidden() if "fake" in m or "reproduce" in m]
        sys.modules["repro.fake_submodule"] = object()
        sys.modules["jaxlib_fake"] = object()
        assert "repro.fake_submodule" in entry.loaded_forbidden()
        assert "jaxlib_fake" not in entry.loaded_forbidden()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_a_tiny_run_loads_neither_jax_nor_repro(tmp_path):
    code = (
        "import sys, time, json, torch; torch.set_num_threads(1)\n"
        "from perfbench.tests.tiny import make_tiny\n"
        "from perfbench.harness import run_cell\n"
        "from pathlib import Path\n"
        f"spec = make_tiny(Path({str(tmp_path)!r}))\n"
        "r, _, _ = run_cell(spec, 'tiny.full', 7, 0.2, False, 'cpu', time.perf_counter(),\n"
        "                log=lambda s: None)\n"
        "bad = sorted({m for m in sys.modules if m.split('.')[0] in\n"
        "              ('jax', 'jaxlib', 'flax', 'repro')})\n"
        "print(json.dumps({'bad': bad, 'correct': r['correct']}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "correct": True}


def _entry(cwd: Path, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "qwen2-7b.full_data", "--seed", "3", "--seconds", "1", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _entry(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
