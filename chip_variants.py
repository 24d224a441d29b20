#!/usr/bin/env python3
"""Design measurements of the port's redesigned kernels on one NVIDIA card.

Studies, each building altered copies of a kernel source with nvcc
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
  --ablate-ring          ``topk_sim`` at the Covtype-shaped class 0 (k = 64)
                         and ``fl_replay`` at the service's finalize: the
                         committed kernel, then copies without a part (the
                         product loop, the merge, the loads) or with 8
                         consumer warps in ``topk_sim``; wrong results,
                         only the times are read.
  --topk-baseline PATH   ``topk_sim``: the committed kernel against another
                         ``topk_sim.cu`` (it may include the unchanged
                         ``dot_tile.cuh`` of csrc/): bitwise equal (vals,
                         idx) at chip_smoke.py's TOPK_CHECKS with k <= 128
                         and at the Covtype-shaped class 0, both timed
                         there (committed, baseline, committed, baseline).
  --replay-baseline PATH ``fl_replay``: the committed kernel against another
                         ``fl_replay.cu``: bitwise equal (gains, cur,
                         best_v, best_i) at chip_smoke.py's REPLAY_CHECKS
                         and at the service's finalize shape (65,536 ×
                         1,024 × 2,048), both timed there.
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
    python3 chip_variants.py --topk-baseline build/topk_prev.cu \
        --replay-baseline build/replay_prev.cu

Registers and CTAs per SM are logged for both sides: the committed
kernels' from their C occupancy entries (cudaFuncGetAttributes and
cudaOccupancyMaxActiveBlocksPerMultiprocessor), the baseline's from its
``-Xptxas -v`` output.
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


# Ablations of the streamed-tile kernels at their main-path shapes: text in
# the committed source, replacement.  Only the times are read.
_SINK = [
    ("  float acc[TN][TM];\n  for (int it = 0; it < items; ++it) {",
     "  unsigned sink = 0;\n  float acc[TN][TM];\n  for (int it = 0; it < items; ++it) {"),
    ("  if constexpr (KPL > 0) {\n#pragma unroll\n    for (int i = 0; i < TN; ++i) {\n      const int r",
     "  if (lane == 0 && sink == 0x7fffffffu) vals[0] = 1.f;\n  if constexpr (KPL > 0) {\n"
     "#pragma unroll\n    for (int i = 0; i < TN; ++i) {\n      const int r"),
]
_NO_PRODUCT = [("    for (int k4 = 0; k4 < plan.kfull; k4 += 4) {",
                "    for (int k4 = 0; k4 < 0; k4 += 4) {")]
_NO_MERGE = [("      if (!((hit >> i) & 1u)) continue;  // warp-uniform",
              "      sink += hit;\n      if (true) continue;"), *_SINK]
RING_ABLATIONS = {
    "topk_sim": {
        "no product": _NO_PRODUCT,
        "no merge": _NO_MERGE,
        "no product, no merge": _NO_PRODUCT + _NO_MERGE,
        "8 consumer warps": [("constexpr int WARPS = 11;", "constexpr int WARPS = 8;")],
    },
    "fl_replay": {
        "no loads": [("      if (tma) {\n        if (lane == 0) {",
                      "      if (tma) {\n        mbar_arrive(full);\n        continue;\n      }\n"
                      "      if (false) {\n        if (lane == 0) {")],
        "no product": [("    for (int c = 0; c < KC / 4; ++c) {", "    for (int c = 0; c < 0; ++c) {")],
    },
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
         "-fPIC", "-Xptxas", "-v", "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {tag}:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES[name].items():
        if hasattr(cdll, fn):  # an earlier source may lack a newer entry
            getattr(cdll, fn).argtypes = list(argtypes)
            getattr(cdll, fn).restype = ctypes.c_int
    cdll.ptxas = proc.stdout + proc.stderr
    return cdll


def use_library(name: str, cdll) -> None:
    """Route the launch wrappers of source ``name`` to ``cdll`` (None: the
    committed build)."""
    from repro_torch.kernels import _build

    if not hasattr(use_library, "committed"):
        use_library.committed = _build.library
    _build.library = (use_library.committed if cdll is None
                      else (lambda n: cdll if n == name else use_library.committed(n)))


def variants(name: str, ablations: dict) -> dict:
    """{"committed": None, tag: library of the committed source with the
    tag's replacements} for source ``name``."""
    from repro_torch.kernels import _build

    src = _build.source(name).read_text()
    runs = {"committed": None}
    for tag, subs in ablations.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"ablation {tag!r}: anchor not in {name}.cu: {old!r}")
            text = text.replace(old, new)
        runs[tag] = load_variant(name, text, tag.replace(" ", "_").replace(",", ""))
    return runs


def ablate_ring(torch, cs) -> None:
    import numpy as np

    from repro_torch.kernels import fl_gains as kfl, topk_sim as ktk

    dev = torch.device("cuda")
    feats, y = cs.covtype_pool(dev)
    x0 = feats[torch.as_tensor(np.nonzero(y == 0)[0], device=dev)].contiguous()
    del feats
    sq0 = torch.sum(x0 * x0, dim=1)
    dm0 = 2.0 * torch.sqrt(sq0.max()) + 1e-6
    pool = torch.cat(cs.service_deltas(torch, dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    e = pool[torch.randperm(pool.shape[0], device=dev, generator=gen)[:cs.SVC_BUDGET]]
    sqx, sqe = torch.sum(pool * pool, dim=1), torch.sum(e * e, dim=1)
    valid = torch.ones(cs.SVC_BUDGET, dtype=torch.bool, device=dev)
    cur0 = torch.zeros(pool.shape[0], device=dev)
    d_max = (2.0 * torch.sqrt(sqx.max()) + 1e-6).reshape(())
    calls = {
        "topk_sim": (lambda: ktk.topk_sim_cuda(x0, sq0, dm0, cs.COV_K), 3,
                     f"Covtype class 0 ({x0.shape[0]} × {cs.COV_D}, k={cs.COV_K})"),
        "fl_replay": (lambda: kfl.fl_replay_cuda(pool, e, sqx, sqe, valid, d_max, cur0), 10,
                      f"service finalize ({pool.shape[0]} × {cs.SVC_BUDGET} × {cs.SVC_DIM})"),
    }
    for name, ablations in RING_ABLATIONS.items():
        fn, reps, shape = calls[name]
        ms = {}
        for tag, cdll in variants(name, ablations).items():
            use_library(name, cdll)
            ms[tag] = cs.median_ms(torch, fn, reps, warm=1)
        use_library(name, None)
        for tag, t in ms.items():
            log(f"[ablate] {name} at the {shape}, {tag}: {t:.3f} ms")


def ablate(torch, cs) -> None:
    from repro_torch.kernels import ce_proxy as kce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    T, D, V = 4096, 2048, 151_936
    h = torch.randn(T, D, device=dev, generator=gen).bfloat16()
    w = (0.05 * torch.randn(V, D, device=dev, generator=gen)).bfloat16()
    y = torch.randint(0, V, (T,), device=dev, generator=gen).int()
    runs = variants("ce_proxy", ABLATIONS)
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


def ptxas_kernels(text: str) -> dict:
    """{kernel function: (registers per thread, static shared bytes)} from
    ``nvcc -Xptxas -v`` output."""
    out, fn = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "Used" in ln and "registers" in ln and fn:
            words = ln.replace(",", "").split()
            regs = int(words[words.index("registers") - 1])
            smem = int(words[words.index("smem") - 2]) if "smem" in words else 0
            out[fn] = (regs, smem)
            fn = None
    return out


def ctas_per_sm(regs: int, smem: int, threads: int) -> int:
    """CTAs an H100 SM holds of a kernel (registers allocated 256 a warp,
    64 warps, 32 CTAs and 228 KB of shared memory an SM, 1 KB of it
    reserved a CTA)."""
    warps = -(-threads // 32)
    by_regs = 65536 // (warps * 256 * -(-regs * 32 // 256)) if regs else 32
    return min(by_regs, 64 // warps, 32, (228 * 1024) // (smem + 1024))


def log_baseline_build(cs, what: str, cdll, threads: int) -> None:
    for fn, (regs, smem) in ptxas_kernels(cdll.ptxas).items():
        log(f"[{what}] baseline {fn}: {regs} registers, {smem} B static smem, "
            f"{ctas_per_sm(regs, smem, threads)} CTAs/SM")


def bitwise(torch, a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def topk_baseline(torch, cs, path: Path) -> None:
    import numpy as np

    from repro_torch.kernels import _build, ops, topk_sim as ktk

    base = load_variant("topk_sim", path.read_text(), "baseline")
    log_baseline_build(cs, "topk", base, 256)
    lib = _build.library("topk_sim")
    for k in (32, 64, 96, 128, 256):
        regs, ctas = cs.occupancy(lib, "topk_sim_occupancy", cs.COV_D, k)
        log(f"[topk] committed kernel at d={cs.COV_D}, k={k}: {regs} registers, {ctas} CTAs/SM")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(f"n={n} d={d} k={k}", torch.randn(n, d, device=dev, generator=gen), k)
             for n, d, k in cs.TOPK_CHECKS if k <= 128]
    feats, y = cs.covtype_pool(dev)
    x0 = feats[torch.as_tensor(np.nonzero(y == 0)[0], device=dev)].contiguous()
    del feats
    cases.append((f"Covtype class 0, n={x0.shape[0]} d={cs.COV_D} k={cs.COV_K}", x0, cs.COV_K))
    equal = 0
    for label, x, k in cases:
        got = {}
        for tag, cdll in (("committed", None), ("baseline", base)):
            use_library("topk_sim", cdll)
            got[tag] = ops.topk_sim(x, k, impl="cuda")
        use_library("topk_sim", None)
        same = bitwise(torch, got["committed"], got["baseline"])
        equal += same
        log(f"[topk] {label}: committed against {path}: (vals, idx) bitwise equal {same}")
    log(f"[topk] bitwise equal at {equal} of {len(cases)} shapes")
    sq0 = torch.sum(x0 * x0, dim=1)
    dm0 = 2.0 * torch.sqrt(sq0.max()) + 1e-6
    for tag, cdll in (("committed", None), ("baseline", base)) * 2:
        use_library("topk_sim", cdll)
        t = cs.median_ms(torch, lambda: ktk.topk_sim_cuda(x0, sq0, dm0, cs.COV_K), 3, warm=1)
        log(f"[topk] Covtype class 0 ({x0.shape[0]} × {cs.COV_D}, k={cs.COV_K}), {tag}: "
            f"{t:.3f} ms")
    use_library("topk_sim", None)


def replay_baseline(torch, cs, path: Path) -> None:
    from repro_torch.kernels import _build, fl_gains as kfl, ops

    base = load_variant("fl_replay", path.read_text(), "baseline")
    log_baseline_build(cs, "replay", base, 256)
    regs, ctas = cs.occupancy(_build.library("fl_replay"), "fl_replay_occupancy")
    log(f"[replay] committed kernel: {regs} registers, {ctas} CTAs/SM")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(x, m):
        n = x.shape[0]
        e = x[torch.randperm(n, device=dev, generator=gen)[:m]].contiguous()
        valid = torch.rand(m, device=dev, generator=gen) < 0.9
        valid[0] = True
        cur0 = torch.rand(n, device=dev, generator=gen)
        d_max = 2.0 * torch.sqrt(torch.sum(x * x, dim=1).max()) + 1e-6
        return x, e, valid, cur0, d_max

    cases = [(f"n={n} m={m} d={d}", operands(torch.randn(n, d, device=dev, generator=gen), m))
             for n, m, d in cs.REPLAY_CHECKS]
    pool = torch.cat(cs.service_deltas(torch, dev))
    svc = operands(pool, cs.SVC_BUDGET)
    cases.append((f"service finalize, n={pool.shape[0]} m={cs.SVC_BUDGET} d={cs.SVC_DIM}", svc))
    equal = 0
    for label, args in cases:
        got = {}
        for tag, cdll in (("committed", None), ("baseline", base)):
            use_library("fl_replay", cdll)
            got[tag] = ops.fl_replay(*args, impl="cuda")
        use_library("fl_replay", None)
        same = bitwise(torch, got["committed"], got["baseline"])
        equal += same
        log(f"[replay] {label}: committed against {path}: (gains, cur, best_v, best_i) "
            f"bitwise equal {same}")
    log(f"[replay] bitwise equal at {equal} of {len(cases)} shapes")
    x, e, valid, cur0, d_max = svc
    sqx, sqe = torch.sum(x * x, dim=1), torch.sum(e * e, dim=1)
    d_max = d_max.reshape(())
    for tag, cdll in (("committed", None), ("baseline", base)) * 2:
        use_library("fl_replay", cdll)
        t = cs.median_ms(torch, lambda: kfl.fl_replay_cuda(x, e, sqx, sqe, valid, d_max, cur0),
                         10)
        log(f"[replay] service finalize ({x.shape[0]} × {cs.SVC_BUDGET} × {cs.SVC_DIM}), "
            f"{tag}: {t:.3f} ms")
    use_library("fl_replay", None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--ablate-ring", action="store_true")
    ap.add_argument("--ce-baseline", type=Path)
    ap.add_argument("--fl-baseline", type=Path)
    ap.add_argument("--topk-baseline", type=Path)
    ap.add_argument("--replay-baseline", type=Path)
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
    if args.ablate_ring:
        ablate_ring(torch, cs)
    if args.ce_baseline:
        ce_baseline(torch, cs, args.ce_baseline)
    if args.fl_baseline:
        fl_baseline(torch, cs, args.fl_baseline)
    if args.topk_baseline:
        topk_baseline(torch, cs, args.topk_baseline)
    if args.replay_baseline:
        replay_baseline(torch, cs, args.replay_baseline)


if __name__ == "__main__":
    main()
