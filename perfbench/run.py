"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload qwen2-7b.refresh_every_epoch \
        --seed 12345 --seconds 30 --trace 0

from the root of a checkout.  Exits non-zero without a result when no CUDA
card is present, when the cell asks for more cards than there are, or when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once
the window has closed.  The last line of standard output is the result
object; the last lines of standard error are the numbers compared, each
beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    # run as a script, this file's directory leads sys.path: its modules
    # are imported as the package's, never as top-level names
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench.harness import run_cell
    from perfbench.spec import Spec

    spec = Spec(ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result, lines, _ = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START, log=lambda s: print(s, flush=True))
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
