"""Build and bind the port's CUDA kernels (no counterpart in ``repro``).

Every ``csrc/*.cu`` source has a plain C interface (``csrc/*.cuh`` are
headers they share).  At first use each is
compiled with ``nvcc`` for ``sm_90a`` into its own shared library under
the repository's ``build/`` directory, named by a hash of the source, and
loaded with ``ctypes``; :func:`build_all` starts one ``nvcc`` per source
at once.  Nothing is compiled or loaded at import time, so the package
imports on machines without CUDA.

Every C entry returns ``cudaGetLastError()`` after its launch; the
wrappers raise when it is not 0.  :data:`LAUNCHES` counts kernel launches
per kernel, bumped only by the launch wrappers.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "SIGNATURES", "LAUNCHES", "source", "build",
           "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/src/repro_torch/kernels/_build.py -> <repo>/build
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# Kernel launches per kernel, bumped only where a kernel is launched.
LAUNCHES: dict[str, int] = {
    "fl_gains": 0, "fl_gains_argmax": 0, "ce_proxy": 0,
    "topk_sim": 0, "pairwise_l2": 0, "fl_replay": 0,
    "adamw_sq_norm": 0, "adamw_update": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of each source's entry points.
SIGNATURES: dict[str, dict[str, tuple]] = {
    "fl_gains": {
        "fl_gains_block_m": (),
        "fl_gains_f32": (_P,) * 6 + (_I,) * 3 + (_P,),
        "fl_gains_argmax_f32": (_P,) * 9 + (_I,) * 3 + (_P,),
        "fl_gains_argmax_bf16": (_P,) * 9 + (_I,) * 3 + (_P,),
    },
    "ce_proxy": {
        "ce_proxy_f32": (_P,) * 4 + (_I,) * 4 + (_P,),
        "ce_proxy_bf16": (_P,) * 4 + (_I,) * 4 + (_P,),
        "ce_proxy_bf16_auto_route": (_I,),
        "ce_proxy_bf16_clusters": (_I, _P, _P),
    },
    "topk_sim": {
        "topk_sim_f32": (_P,) * 5 + (_I,) * 3 + (_P,),
        "topk_sim_occupancy": (_I, _I, _P, _P),
    },
    "pairwise_l2": {
        "pairwise_l2_f32": (_P,) * 5 + (_I,) * 3 + (_P,),
        "pairwise_l2_occupancy": (_I, _P, _P),
    },
    "fl_replay": {
        "fl_replay_block_rows": (),
        "fl_replay_f32": (_P,) * 11 + (_I,) * 3 + (_P,),
        "fl_replay_occupancy": (_P, _P),
    },
    "adamw": {
        "adamw_max_leaves": (),
        "adamw_sq_norm_f32": (_P, _I, _P, _I, _P, _I, _P),
        "adamw_update_f32": (_P, _I, _P, _I, _P, _I) + (_F,) * 10 + (_P,),
    },
}


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch build only where the CUDA toolkit is "
        "installed"
    )


def _target(name: str) -> Path:
    # the digest covers the shared headers too: a header edit rebuilds
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[Path, str, float]:
    """Compile source ``name`` if its hashed library is missing.

    Returns (library path, compiler output, seconds spent compiling)."""
    out = _target(name)
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(source(name)),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source(name).name}:\n{proc.stdout}")
    os.replace(tmp, out)
    log.write_text(proc.stdout)
    return out, proc.stdout, seconds


def build_all() -> dict[str, tuple[Path, str, float]]:
    """Build every source, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(len(SIGNATURES)) as pool:
        return dict(zip(SIGNATURES, pool.map(build, SIGNATURES)))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built at first use."""
    path, _, _ = build(name)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
