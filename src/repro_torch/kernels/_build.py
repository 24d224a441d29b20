"""Build and bind the port's CUDA kernels (no counterpart in ``repro``).

The kernels live in one source, ``csrc/fl_gains.cu``, with a plain C
interface.  At first use it is compiled with ``nvcc`` for ``sm_90a`` into
a shared library under the repository's ``build/`` directory, named by a
hash of the source, and loaded with ``ctypes``.  Nothing is compiled or loaded at import time, so
the package imports on machines without CUDA.

Every C entry returns ``cudaGetLastError()`` after its launch; the
wrappers in :mod:`repro_torch.kernels.fl_gains` raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "build", "library", "check"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fl_gains.cu"
# <repo>/src/repro_torch/kernels/_build.py -> <repo>/build
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the source's entry points.
SIGNATURES: dict[str, tuple] = {
    "fl_gains_block_m": (),
    "fl_gains_f32": (_P,) * 6 + (_I,) * 3 + (_P,),
    "fl_gains_argmax_f32": (_P,) * 9 + (_I,) * 3 + (_P,),
    "fl_gains_argmax_bf16": (_P,) * 9 + (_I,) * 3 + (_P,),
}


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


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest}.so"


def build() -> tuple[Path, str, float]:
    """Compile the source if its hashed library is missing.

    Returns (library path, compiler output, seconds spent compiling).
    """
    out = _target()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(SOURCE),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{text}")
    os.replace(tmp, out)
    log.write_text(text)
    return out, text, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
