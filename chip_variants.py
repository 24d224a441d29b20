#!/usr/bin/env python3
"""Design measurements of the port's redesigned kernels on one NVIDIA card.

Two studies, each building altered copies of a kernel source with nvcc
into ``build/variants/`` and timing them with CUDA events beside the
committed kernel, in one process on one card:

  --ablate               ``ce_proxy`` bf16 at T = 4,096, D = 2048,
                         V = 151,936: the committed kernel, then copies with
                         one part removed each (the cluster barriers, the
                         reduce-scatter, the logits product, the accumulate
                         product).  The copies compute wrong results; only
                         their times are read, as the cost of each part.
  --ce-baseline PATH     ``ce_proxy`` bf16: the committed kernel against
                         another ``ce_proxy.cu``: bitwise equal outputs at
                         chip_smoke.py's CE_SHAPES, and both timed at the
                         main-path shape.
  --fl-baseline PATH     ``fl_gains``/``fl_gains_argmax``: the committed
                         kernel against another ``fl_gains.cu`` (an earlier
                         version, e.g. ``git show <rev>:src/repro_torch/
                         kernels/csrc/fl_gains.cu > build/fl_prev.cu``): are
                         the gains bitwise equal at chip_smoke.py's check
                         shapes, and the times of both at the Ijcnn1-shaped
                         sweeps (n = m = 33,216 and 16,774, d = 22).

Run from the repository root:

    python3 chip_variants.py --ablate --fl-baseline build/fl_prev.cu
    python3 chip_variants.py --ce-baseline build/ce_prev.cu
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "variants"

# Each ablation: (text in csrc/ce_proxy.cu, replacement).
ABLATIONS = {
    "no cluster barriers": [
        ('    asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");\n'
         "    // while the partials", "    // while the partials"),
        ('    asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n\n'
         "    // 2. reduce", "\n    // 2. reduce"),
        ('    asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");\n'
         "    // while P and c", "    // while P and c"),
        ('    asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n'
         '    asm volatile("wgmma.wait_group', '    asm volatile("wgmma.wait_group'),
    ],
    "no reduce-scatter": [
        ("      for (int it = 0; it < iters; ++it) {",
         "      for (int it = 0; it < 0; ++it) {"),
    ],
    "no logits product": [
        ("      wgmma_m64n64_kk(sacc, da, db, (p | k) != 0);", "      (void)da; (void)db;"),
    ],
    "no accumulate product": [
        ("      wgmma_m64n256_rs_mn(acc, a[k], db, 1);", "      (void)db;"),
    ],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def load_variant(name: str, src: str, tag: str) -> ctypes.CDLL:
    """nvcc ``src`` (a variant of source ``name``) into its own library,
    bound with the committed source's C signatures."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}_{tag}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}_{tag}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-o", str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {tag}:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES[name].items():
        getattr(cdll, fn).argtypes = list(argtypes)
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def use_library(name: str, cdll) -> None:
    """Route the launch wrappers of source ``name`` to ``cdll`` (None: the
    committed build)."""
    from repro_torch.kernels import _build

    if not hasattr(use_library, "committed"):
        use_library.committed = _build.library
    _build.library = (use_library.committed if cdll is None
                      else (lambda n: cdll if n == name else use_library.committed(n)))


def ablate(torch, cs) -> None:
    from repro_torch.kernels import _build, ce_proxy as kce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    T, D, V = 4096, 2048, 151_936
    h = torch.randn(T, D, device=dev, generator=gen).bfloat16()
    w = (0.05 * torch.randn(V, D, device=dev, generator=gen)).bfloat16()
    y = torch.randint(0, V, (T,), device=dev, generator=gen).int()
    src = _build.source("ce_proxy").read_text()
    runs = {"committed": None}
    for tag, subs in ABLATIONS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablation {tag!r}: anchor not in ce_proxy.cu: {old!r}")
            text = text.replace(old, new)
        runs[tag] = load_variant("ce_proxy", text, tag.replace(" ", "_"))
    ms = {}
    for tag, cdll in runs.items():
        use_library("ce_proxy", cdll)
        ms[tag] = cs.median_ms(torch, lambda: kce.ce_proxy_cuda(h, w, y, V), 5)
    use_library("ce_proxy", None)
    for tag, t in ms.items():
        log(f"[ablate] ce_proxy bf16 T={T} D={D} V={V}, {tag}: {t:.3f} ms"
            + ("" if tag == "committed" else f" (part costs {ms['committed'] - t:.3f} ms)"))


def ce_baseline(torch, cs, path: Path) -> None:
    from repro_torch.kernels import ce_proxy as kce

    base = load_variant("ce_proxy", path.read_text(), "baseline")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for T, D, V, vv in cs.CE_SHAPES:
        h = torch.randn(T, D, device=dev, generator=gen).bfloat16()
        w = (0.05 * torch.randn(V, D, device=dev, generator=gen)).bfloat16()
        y = torch.randint(0, vv, (T,), device=dev, generator=gen).int()
        got = {}
        for label, cdll in (("committed", None), ("baseline", base)):
            use_library("ce_proxy", cdll)
            got[label] = kce.ce_proxy_cuda(h, w, y, vv)
        use_library("ce_proxy", None)
        log(f"[ce] T={T} D={D} V={V} valid_v={vv}: committed against {path}: bitwise "
            f"equal {torch.equal(got['committed'], got['baseline'])}, max |Δ| "
            f"{float((got['committed'] - got['baseline']).abs().max()):.3e}")
        if (T, D, V, vv) == cs.CE_SHAPES[0]:
            for label, cdll in (("committed", None), ("baseline", base), ("committed", None)):
                use_library("ce_proxy", cdll)
                t = cs.median_ms(torch, lambda: kce.ce_proxy_cuda(h, w, y, vv), 5)
                log(f"[ce] T={T} D={D} V={V}, {label}: {t:.3f} ms")
            use_library("ce_proxy", None)


def fl_baseline(torch, cs, path: Path) -> None:
    from repro_torch.kernels import fl_gains as kfl, ops

    base = load_variant("fl_gains", path.read_text(), "baseline")
    dev = torch.device("cuda")
    equal = total = 0
    for n in cs.CHECK_SIZES:
        for d in cs.CHECK_DIMS:
            gen = torch.Generator(device=dev).manual_seed(n * 1000 + d)
            x = 3.0 * torch.randn(n, d, device=dev, generator=gen)
            sq = torch.sum(x * x, dim=1)
            d_max = 2.0 * torch.sqrt(sq.max()) + 1e-6
            cur = 0.5 * d_max * torch.rand(n, device=dev, generator=gen)
            chosen = torch.rand(n, device=dev, generator=gen) < 0.3
            for tile in ("float32", "bfloat16"):
                got = {}
                for label, cdll in (("committed", None), ("baseline", base)):
                    use_library("fl_gains", cdll)
                    got[label] = ops.fl_gains_argmax(x, x, cur, sq, sq, d_max, chosen,
                                                     tile_dtype=tile, gains_impl="cuda")
                use_library("fl_gains", None)
                total += 1
                equal += all(torch.equal(a, b) for a, b in zip(got["committed"], got["baseline"]))
    log(f"[fl] fl_gains_argmax, committed against {path}: bitwise equal (gains, part_g, "
        f"part_i) at {equal} of {total} (n, d, tile) cases")
    for n in cs.CLASS_SIZES.values():
        gen = torch.Generator(device=dev).manual_seed(n)
        x = 3.0 * torch.randn(n, cs.D_MAIN, device=dev, generator=gen)
        sq = torch.sum(x * x, dim=1)
        madj = (2.0 * torch.sqrt(sq.max()) + 1e-6).expand(n).contiguous()
        chosen = torch.zeros(n, dtype=torch.bool, device=dev)
        for label, cdll in (("committed", None), ("baseline", base), ("committed", None)):
            use_library("fl_gains", cdll)
            a = cs.median_ms(torch, lambda: kfl.fl_gains_argmax_cuda(x, x, madj, sq, sq, chosen))
            g = cs.median_ms(torch, lambda: kfl.fl_gains_cuda(x, x, madj, sq, sq))
            log(f"[fl] n=m={n}, d={cs.D_MAIN}, {label}: fl_gains_argmax {a:.4f} ms, "
                f"fl_gains {g:.4f} ms")
        use_library("fl_gains", None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--ce-baseline", type=Path)
    ap.add_argument("--fl-baseline", type=Path)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: no CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"card: {cs.card_line()}")
    if args.ablate:
        ablate(torch, cs)
    if args.ce_baseline:
        ce_baseline(torch, cs, args.ce_baseline)
    if args.fl_baseline:
        fl_baseline(torch, cs, args.fl_baseline)


if __name__ == "__main__":
    main()
