#!/usr/bin/env python3
"""Design measurements of the port's redesigned kernels on one NVIDIA card.

Studies, each building altered copies of a kernel source with nvcc
into ``build/variants/`` and timing them with CUDA events beside the
committed kernel, in one process on one card:

  --ablate               ``ce_proxy`` bf16 at T = 4,096, D = 2048,
                         V = 151,936 and at the (D, padded V) of
                         chip_smoke.py's CE_WIDE (route 1, and route 2 in 7-,
                         8- and 12-CTA clusters): the
                         committed kernel, then copies with one part
                         removed each (the cluster barriers, the
                         reduce-scatter, the logits product, the accumulate
                         product).  The copies compute wrong results; only
                         their times are read, as the cost of each part.
                         Then the other cluster route forced where it takes
                         the width, in a copy with ``auto_route`` patched
                         (route 2 at D = 2048; route 1 widened to 14- or
                         16-CTA clusters at D <= 4096), timed and held to the
                         committed route within chip_smoke.py's ce_tol.
  --ce-baseline PATH     ``ce_proxy`` bf16: the committed kernel against
                         another ``ce_proxy.cu``: bitwise equal outputs at
                         chip_smoke.py's CE_SHAPES of D <= 2048 (the widths
                         an earlier source takes), and both timed at the
                         main-path shape.
  --ablate-ring          ``topk_sim`` at the Covtype-shaped class 0 (k = 64),
                         ``fl_replay`` at the service's finalize and
                         ``pairwise_l2`` at the main-path block's shape: the
                         committed kernel, then copies without a part (the
                         product loop, the merge, the loads, the stores, the
                         root) or with 8 consumer warps in ``topk_sim``;
                         wrong results, only the times are read.  Then the
                         SM clock and power that nvidia-smi reads while
                         ``pairwise_l2`` runs for a few seconds.
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
  --l2-baseline PATH     ``pairwise_l2``: the committed kernel against another
                         ``pairwise_l2.cu`` (an earlier one includes
                         ``dot_tile.cuh``: put it beside PATH): bitwise equal
                         distances at chip_smoke.py's PAIR_CHECKS and at the
                         main-path block (the Covtype-shaped selection's
                         first class-0 block against its 22,378 medoids),
                         every class's assignment equal, both timed at the
                         block (committed, baseline, committed, baseline).
  --twin-baseline PATH...  ``topk_sim``'s plain twin against other
                         ``topk_sim.py`` files (e.g. ``git show <rev>:src/
                         repro_torch/kernels/topk_sim.py > build/twin_prev.py``)
                         on the first 20,000 rows of the Covtype-shaped
                         class 0 (k = 64): results compared, each timed on
                         the host CPU (committed, baselines, twice) and its
                         peak bytes on the card's allocator, less the
                         inputs.
  --fl-baseline PATH     ``fl_gains``/``fl_gains_argmax``: the committed
                         kernel against another ``fl_gains.cu`` (an earlier
                         version, e.g. ``git show <rev>:src/repro_torch/
                         kernels/csrc/fl_gains.cu > build/fl_prev.cu``): are
                         the gains bitwise equal at chip_smoke.py's check
                         shapes, and the times of both at the Ijcnn1-shaped
                         sweeps (n = m = 33,216 and 16,774, d = 22).
  --lr-probe             chip_smoke.py's phase 9 under other AdamW peak
                         rates: every training config of its WIDE_LM at
                         published width (and nemotron-4-15b at 1 layer),
                         9 steps of ``train_lm`` at each (rate, warm-up) of
                         LR_PROBE, logging the step losses.  A run whose
                         last loss is not below its first is logged as
                         such; any other failure raises.
  --silu-probe           one qwen3-1.7b training step (28 layers, 8 × 512
                         tokens, ``make_train_step`` with AdamW, as
                         chip_smoke.py's phase 6 steps) with the gated
                         FFN's SiLU as ``layers._silu`` (op by op in bf16,
                         as ``jax.nn.silu`` rounds) and as ``F.silu`` (one
                         fused kernel), alternated; and the activation
                         alone at the FFN's (4,096, 6,144) bf16, forward
                         and backward.
  --ce-probe             one qwen3-1.7b training step (28 layers, 8 × 512
                         tokens, AdamW, as --silu-probe) with the chunked
                         CE as shipped for plain tensors (``model.
                         _ce_chunk``: ATen's fused ``torch.logsumexp`` and
                         a ``gather`` for the gold logit) and in the form
                         it takes on a mesh (logsumexp op by op as
                         ``model._LogSumExp``, the gold logit by a one-hot
                         reduce), alternated: step times, peak bytes, and
                         whether the two losses of one forward are equal;
                         and one chunk alone at the main-path shape,
                         forward and backward.
  --count-ops            on the CPU, no card needed: the dispatcher calls
                         of one sLSTM scan step and of one decode step of
                         each xLSTM layer kind (``torch.profiler``).
  --serve-probe [ARCH …] chip_smoke.py phase 12's forward-against-decode
                         error, taken apart: qwen3-1.7b, recurrentgemma-9b,
                         xlstm-1.3b and musicgen-medium (or the ARCHs
                         named) at full depth with cuBLAS's
                         reduced-precision bf16 reductions on and off and
                         with fp32 products, then the first k layers of
                         the same weights, over all 64 steps and over the
                         first 24 (the reference's own gates hold 24 steps
                         at 2 to 5 layers: chip_smoke.py's SERVE_EMB_CELLS
                         grow them by the ratio read here); and
                         moonshot-v1-16b-a3b at 8 layers with the forward
                         routed natively, counting the token-layers whose
                         expert sets differ from the decode step's.

Run from the repository root:

    python3 chip_variants.py --ablate --fl-baseline build/fl_prev.cu
    python3 chip_variants.py --ce-baseline build/ce_prev.cu
    python3 chip_variants.py --topk-baseline build/topk_prev.cu \
        --replay-baseline build/replay_prev.cu
    python3 chip_variants.py --l2-baseline build/base/pairwise_l2.cu
    python3 chip_variants.py --lr-probe

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
# (peak rate, warm-up steps) of ``--lr-probe``
LR_PROBE = ((3e-4, 10), (3e-4, 2), (1e-4, 10), (1e-4, 2), (5e-5, 2), (3e-5, 2))

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
# The other cluster route, forced in a copy of csrc/ce_proxy.cu: route 2 for
# every D <= 8192, or route 1 widened to non-portable clusters of up to 16
# CTAs (D <= 4096).  Held to the committed route within ce_tol.
ROUTE_FORCES = {
    2: [("  return D <= D_PORTABLE ? ROUTE_SL1 : D <= D_SL2 ? ROUTE_SL2 : ROUTE_SIMT;",
         "  return D <= D_SL2 ? ROUTE_SL2 : ROUTE_SIMT;")],
    1: [("SL == 1 ? CL_PORTABLE : CL_NONPORTABLE", "CL_NONPORTABLE")],
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
_L2_STORE = ("        if (c0 + lane + 32 * j < m) __stcs(orow + 32 * j, v);",
             "        if (v == -1.f) __stcs(orow + 32 * j, v);")
_L2_ROOT = ("sqrt_rn(fmaxf((sx[i] + sy[j]) - 2.f * acc[i][j], 0.f))",
            "fmaxf((sx[i] + sy[j]) - 2.f * acc[i][j], 0.f)")
# every dim reads the operands of dims 0 and 1: loop-invariant loads the
# compiler hoists, so the loop keeps its FFMAs and loses its shared loads
_L2_LOADS = [
    ("          const float4 a = *reinterpret_cast<const float4*>(xs + k * TN + 4 * q);",
     "          const float4 a = *reinterpret_cast<const float4*>(xs + 4 * q);"),
    ("          const float4 b = *reinterpret_cast<const float4*>(xs + (k + 1) * TN + 4 * q);",
     "          const float4 b = *reinterpret_cast<const float4*>(xs + TN + 4 * q);"),
    ("          cv[j] = *reinterpret_cast<const float2*>(cr + 32 * j * plan.cp + k);",
     "          cv[j] = *reinterpret_cast<const float2*>(cr + 32 * j * plan.cp);"),
]
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
    "pairwise_l2": {
        "no product": [("      for (int k = 0; k < plan.kw; k += 2) {",
                        "      for (int k = 0; k < 0; k += 2) {")],
        "no stores": [_L2_STORE],
        "no root": [_L2_ROOT],
        "no shared loads": _L2_LOADS,
        "FFMA only (no loads, root or stores)": _L2_LOADS + [_L2_ROOT, _L2_STORE],
        "15 warps of 4 rows": [("constexpr int WARPS = 11; ", "constexpr int WARPS = 15; "),
                               ("constexpr int TN = 8; ", "constexpr int TN = 4; ")],
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def load_variant(name: str, src: str, tag: str, include: Path | None = None) -> ctypes.CDLL:
    """nvcc ``src`` (a variant of source ``name``) into its own library,
    bound with the committed source's C signatures; ``include`` is searched
    for headers before csrc/."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}_{tag}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}_{tag}.so"
    inc = ["-I", str(include)] if include else []
    proc = subprocess.run(
        [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", *inc, "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
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


def clocks_under_load(torch, fn, seconds: float = 4.0) -> list:
    """nvidia-smi's SM clock, power draw and throttle reasons, sampled twice
    a second while ``fn`` runs back to back."""
    import threading
    import time

    samples = []

    def sample():
        for _ in range(int(2 * seconds)):
            proc = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
                 "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
            samples.append(proc.stdout.strip())
            time.sleep(0.5)

    th = threading.Thread(target=sample)
    th.start()
    while th.is_alive():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    th.join()
    return samples


def ablate_ring(torch, cs) -> None:
    import numpy as np

    from repro_torch.core.engines import sparse
    from repro_torch.kernels import fl_gains as kfl, pairwise_l2 as kpw, topk_sim as ktk

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
    r0 = cs.COV_BUDGETS[0]
    s0 = x0[torch.randperm(x0.shape[0], device=dev, generator=gen)[:r0]].contiguous()
    xb = x0[:sparse.ASSIGN_BLOCK_BYTES // (4 * r0)].contiguous()
    sqb, sqs = torch.sum(xb * xb, dim=1), torch.sum(s0 * s0, dim=1)
    calls = {
        "topk_sim": (lambda: ktk.topk_sim_cuda(x0, sq0, dm0, cs.COV_K), 3,
                     f"Covtype class 0 ({x0.shape[0]} × {cs.COV_D}, k={cs.COV_K})"),
        "fl_replay": (lambda: kfl.fl_replay_cuda(pool, e, sqx, sqe, valid, d_max, cur0), 10,
                      f"service finalize ({pool.shape[0]} × {cs.SVC_BUDGET} × {cs.SVC_DIM})"),
        "pairwise_l2": (lambda: kpw.pairwise_l2_cuda(xb, s0, sqb, sqs), 10,
                        f"main-path block shape ({xb.shape[0]} × {r0} × {cs.COV_D})"),
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
    fn = calls["pairwise_l2"][0]
    log(f"[ablate] pairwise_l2 run back to back, nvidia-smi (SM clock, power, throttle "
        f"reasons): {clocks_under_load(torch, fn)}")


def ce_operands(torch, T, D, V, seed=0):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(T, D, device=dev, generator=gen).bfloat16()
    w = (0.05 * torch.randn(V, D, device=dev, generator=gen)).bfloat16()
    y = torch.randint(0, V, (T,), device=dev, generator=gen).int()
    return h, w, y


def ablate(torch, cs) -> None:
    from repro_torch.kernels import ce_proxy as kce

    shapes = [(4096, 2048, 151_936)] + [(4096, D, V) for D, V, _ in cs.CE_WIDE.values()]
    runs = variants("ce_proxy", ABLATIONS)
    forced = {r: v for r, v in variants("ce_proxy", {
        f"route {r} forced": subs for r, subs in ROUTE_FORCES.items()}).items() if v}
    for T, D, V in shapes:
        h, w, y = ce_operands(torch, T, D, V)
        ms = {}
        for tag, cdll in runs.items():
            use_library("ce_proxy", cdll)
            ms[tag] = cs.median_ms(torch, lambda: kce.ce_proxy_cuda(h, w, y, V), 5)
        use_library("ce_proxy", None)
        route = cs.ce_route(D)
        for tag, t in ms.items():
            log(f"[ablate] ce_proxy bf16 T={T} D={D} V={V} (route {route}), {tag}: {t:.3f} ms"
                + ("" if tag == "committed" else f" (part costs {ms['committed'] - t:.3f} ms)"))
        other = 2 if route["route"] == 1 else 1 if D <= 4096 else None
        if other:  # the other cluster route at this width
            lib = forced[f"route {other} forced"]
            want = kce.ce_proxy_cuda(h, w, y, V)
            use_library("ce_proxy", lib)
            got = kce.ce_proxy_cuda(h, w, y, V)
            err = float((got - want).abs().max())
            tol = cs.ce_tol(w, "bfloat16")
            if err > tol:
                raise AssertionError(f"route {other} at D={D}: max |err| {err} > {tol}")
            t = cs.median_ms(torch, lambda: kce.ce_proxy_cuda(h, w, y, V), 5)
            use_library("ce_proxy", None)
            log(f"[ablate] ce_proxy bf16 T={T} D={D} V={V}, route {other} forced "
                f"({cs.ce_route(D, lib)}): {t:.3f} ms; max |route {other} − route "
                f"{route['route']}| {err:.3e} (tol {tol:.3e})")
        del h, w, y
        torch.cuda.empty_cache()


def lr_probe(torch, cs) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.optim import warmup_cosine

    dev = torch.device("cuda")
    card = cs.card_line()
    runs = [(name, layers) for name, (layers, train) in cs.WIDE_LM.items() if train]
    runs.append(("nemotron-4-15b", 1))
    for name, layers in runs:
        cfg = dataclasses.replace(get_config(name), n_layers=layers)
        for lr, warm in LR_PROBE:
            tag = f"{name} ({layers} layers), peak {lr:g} after {warm} steps"
            try:
                r = cs.train_lm(torch, ops, card, dev, cfg, cs.WIDE_DOCS, "sync",
                                cs.WIDE_STEPS, warmup_cosine(lr, warm, cs.WIDE_STEPS), (2, 1),
                                f"lr probe {tag}", phase=9)
                losses = r["losses"]
            except AssertionError as e:
                if "loss did not fall" not in str(e):
                    raise
                losses = [float(v) for v in str(e).split("[", 1)[1].rstrip("]").split(",")]
            log(f"[lr-probe] {tag}: loss {losses[0]:.3f} → {losses[-1]:.3f} "
                f"({'falls' if losses[-1] < losses[0] else 'does not fall'}); steps "
                f"{[round(v, 3) for v in losses]}")


def ce_baseline(torch, cs, path: Path) -> None:
    from repro_torch.kernels import ce_proxy as kce

    base = load_variant("ce_proxy", path.read_text(), "baseline")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for T, D, V, vv in cs.CE_SHAPES:
        if D > 2048:  # past the widths of an earlier source
            continue
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


def l2_baseline(torch, cs, path: Path) -> None:
    import numpy as np

    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.engines import sparse
    from repro_torch.kernels import _build, ops, pairwise_l2 as kpw

    base = load_variant("pairwise_l2", path.read_text(), "baseline", include=path.parent)
    log_baseline_build(cs, "l2", base, 256)
    regs, ctas = cs.occupancy(_build.library("pairwise_l2"), "pairwise_l2_occupancy", cs.COV_D)
    log(f"[l2] committed kernel at d={cs.COV_D}: {regs} registers, {ctas} CTAs/SM")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(f"n={n} m={m} d={d}", torch.randn(n, d, device=dev, generator=gen),
              torch.randn(m, d, device=dev, generator=gen)) for n, m, d in cs.PAIR_CHECKS]
    # the Covtype-shaped selection (chip_smoke.py phase 7) for its medoids
    feats, y = cs.covtype_pool(dev)
    idx = CraigSelector(CraigConfig(fraction=0.1, per_class=True), device=dev).select(
        feats, y).indices
    pools = [np.nonzero(y == c)[0] for c in range(cs.COV_CLASSES)]
    sels = [np.searchsorted(p, idx[np.isin(idx, p)]) for p in pools]
    x0 = feats[torch.as_tensor(pools[0], device=dev)].contiguous()
    s0 = x0[torch.as_tensor(sels[0], device=dev)].contiguous()
    r0 = s0.shape[0]
    xb = x0[:sparse.ASSIGN_BLOCK_BYTES // (4 * r0)].contiguous()
    cases.append((f"main-path block, Covtype class 0: n={xb.shape[0]} m={r0} d={cs.COV_D}",
                  xb, s0))
    equal = 0
    for label, a, b in cases:
        got = {}
        for tag, cdll in (("committed", None), ("baseline", base)):
            use_library("pairwise_l2", cdll)
            got[tag] = ops.pairwise_l2(a, b, impl="cuda")
        use_library("pairwise_l2", None)
        same = torch.equal(got["committed"], got["baseline"])
        equal += same
        log(f"[l2] {label}: committed against {path}: bitwise equal {same}, max |Δ| "
            f"{float((got['committed'] - got['baseline']).abs().max()):.3e}")
        del got
    log(f"[l2] bitwise equal at {equal} of {len(cases)} shapes")
    # every class's exact assignment (hence γ) through both sources
    same_classes = 0
    for c, (pool, sel) in enumerate(zip(pools, sels)):
        xc = feats[torch.as_tensor(pool, device=dev)]
        got = {}
        for tag, cdll in (("committed", None), ("baseline", base)):
            use_library("pairwise_l2", cdll)
            got[tag] = sparse._blocked_assignment(xc, sel)
        use_library("pairwise_l2", None)
        same_classes += all(np.array_equal(u, v) for u, v in zip(got["committed"],
                                                                 got["baseline"]))
    log(f"[l2] Covtype-shaped selection: assignment and min distances (hence γ) equal "
        f"through both sources in {same_classes} of {cs.COV_CLASSES} classes")
    sqb, sqs = torch.sum(xb * xb, dim=1), torch.sum(s0 * s0, dim=1)
    for tag, cdll in (("committed", None), ("baseline", base)) * 2:
        use_library("pairwise_l2", cdll)
        t = cs.median_ms(torch, lambda: kpw.pairwise_l2_cuda(xb, s0, sqb, sqs), 10)
        log(f"[l2] main-path block ({xb.shape[0]} × {r0} × {cs.COV_D}), {tag}: {t:.3f} ms")
    use_library("pairwise_l2", None)
    t = cs.median_ms(torch, lambda: torch.cdist(xb, s0), 10)
    log(f"[l2] main-path block, torch.cdist: {t:.3f} ms")


def twin_baseline(torch, cs, paths: list) -> None:
    import importlib.util
    import time

    from repro_torch.kernels import topk_sim as ktk

    twins = {"committed": ktk.topk_sim_torch}
    for path in paths:
        spec = importlib.util.spec_from_file_location(f"twin_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        twins[str(path)] = mod.topk_sim_torch
    feats, y = cs.covtype_pool(torch.device("cpu"))
    x = feats[torch.as_tensor((y == 0).nonzero()[0][:20_000])].contiguous()
    sq = torch.sum(x * x, dim=1)
    d_max = 2.0 * torch.sqrt(sq.max()) + 1e-6  # as chip_smoke.py's class-0 graph
    n, k = x.shape[0], cs.COV_K
    log(f"[twin] topk_sim twin at n={n} d={x.shape[1]} k={k} on the host CPU "
        f"({torch.get_num_threads()} threads)")
    got = {}
    for _ in range(2):
        for tag, fn in twins.items():
            t0 = time.perf_counter()
            got[tag] = fn(x, sq, d_max, k)
            log(f"[twin] {tag}: {1e3 * (time.perf_counter() - t0):.1f} ms on the CPU")
    for tag in twins:
        if tag != "committed":
            log(f"[twin] committed against {tag}: vals bitwise equal "
                f"{torch.equal(got[tag][0], got['committed'][0])}, "
                f"{int((got[tag][1] != got['committed'][1]).sum())} of {n * k} idx slots "
                "differ")
    dev = torch.device("cuda")
    xc, sqc, dmc = x.to(dev), sq.to(dev), d_max.to(dev)
    for tag, fn in twins.items():
        fn(xc, sqc, dmc, k)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(xc, sqc, dmc, k)
        torch.cuda.synchronize()
        log(f"[twin] {tag}: peak {torch.cuda.max_memory_allocated() - base} bytes past "
            f"the inputs (card allocator)")


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


SERVE_PROBE_DEPTHS = {"qwen3-1.7b": (4, 8, 16), "recurrentgemma-9b": (3, 6, 12, 24),
                      "xlstm-1.3b": (4, 8, 16, 24), "musicgen-medium": (2, 8, 24)}


def prefill_last(torch, cs, cfg, params, tokens):
    """``make_prefill_step``'s last logits of ``tokens`` (or embeddings)."""
    from repro_torch.serve import make_prefill_step

    with torch.inference_mode():
        return make_prefill_step(cfg)(params, {cs.input_key(cfg): tokens})


def serve_probe(torch, cs, names) -> None:
    import dataclasses

    import repro_torch.models as M
    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    for name in names or SERVE_PROBE_DEPTHS:
        depths = SERVE_PROBE_DEPTHS[name]
        cfg = get_config(name)
        params, _ = cs.serve_params(torch, cfg, dev)
        tokens = cs.seeded_inputs(torch, cfg, dev, 2, 64, 2)
        for reduced in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
            got, _ = cs.forced_decode(torch, cfg, params, tokens, 64)
            want = cs.forward_logits(torch, cfg, params, tokens, 64)
            log(f"[serve] {name}, {cfg.n_layers} layers, reduced-precision bf16 reductions "
                f"{reduced}: decode against forward {cs.rel_err(torch, got, want):.4e}")
            if reduced:
                last = prefill_last(torch, cs, cfg, params, tokens)
                log(f"[serve] {name}, bf16, prefill's last logits against decode's "
                    f"{cs.rel_err(torch, got[:, -1], last):.4e}")
                by_step = [f"{cs.rel_err(torch, got[:, t], want[:, t]):.2e}"
                           for t in (0, 15, 31, 63)]
                log(f"[serve] {name}, bf16, at steps 0, 15, 31, 63: {by_step}")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        # the same in fp32 (KV caches stay bf16, as the reference's): what
        # is left is the two forms' own difference, not bf16 rounding
        M.COMPUTE_DTYPE = M.model.COMPUTE_DTYPE = torch.float32
        try:
            got, _ = cs.forced_decode(torch, cfg, params, tokens, 64)
            want = cs.forward_logits(torch, cfg, params, tokens, 64)
        finally:
            M.COMPUTE_DTYPE = M.model.COMPUTE_DTYPE = torch.bfloat16
        log(f"[serve] {name}, {cfg.n_layers} layers, fp32 products: decode against forward "
            f"{cs.rel_err(torch, got, want):.4e}")
        step_err = [f"{cs.rel_err(torch, got[:, t], want[:, t]):.2e}" for t in (0, 15, 31, 63)]
        log(f"[serve] {name}, fp32, at steps 0, 15, 31, 63: {step_err}")
        for k in depths:
            sub = {key: v for key, v in params.items()
                   if not key.startswith("layers.") or int(key.split(".")[1]) < k}
            c = dataclasses.replace(cfg, n_layers=k)
            got, _ = cs.forced_decode(torch, c, sub, tokens, 64)
            want = cs.forward_logits(torch, c, sub, tokens, 64)
            log(f"[serve] {name}, first {k} layers: {cs.rel_err(torch, got, want):.4e} over 64 "
                f"steps, {cs.rel_err(torch, got[:, :24], want[:, :24]):.4e} over the first 24")
        del params, sub
        torch.cuda.empty_cache()
    if names:
        return
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=8)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params, _ = cs.serve_params(torch, cfg, dev)
    tokens = cs.seeded_tokens(torch, cfg, dev, 2, 32, 2)
    (got, _), dec = cs.recorded_routes(torch, lambda: cs.forced_decode(torch, cfg, params,
                                                                        tokens, 32))
    want, fwd = cs.recorded_routes(torch, lambda: cs.forward_logits(torch, cfg, params, tokens,
                                                                     32))
    apart = sum(int((torch.cat([dec[t * cfg.n_layers + layer] for t in range(32)], 1)
                     .sort(-1).values != fwd[layer].sort(-1).values).any(-1).sum())
                for layer in range(cfg.n_layers))
    log(f"[serve] moonshot-v1-16b-a3b, 8 layers, forward routed natively: decode against "
        f"forward {cs.rel_err(torch, got, want):.4e}; {apart} of {2 * 32 * cfg.n_layers} "
        f"token-layers routed to other expert sets")


def silu_probe(torch, cs) -> None:
    import statistics
    import time

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, to_device
    from repro_torch.models import init_params, layers
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = get_config(cs.LM_ARCH)
    own = layers._ACTIVATIONS["silu"]
    forms = {"layers._silu (op by op)": own, "F.silu (fused)": F.silu}
    # the activation alone at the gated FFN's shape, forward and backward
    x = torch.randn(cs.LM_BATCH * cs.LM_SEQ, cfg.d_ff, device=dev).to(torch.bfloat16)
    for label, fn in forms.items():
        xg = x.detach().requires_grad_(True)
        fwd = lambda: fn(xg)  # noqa: E731
        y = fn(xg)
        g = torch.ones_like(y)
        bwd = lambda: torch.autograd.grad(fn(xg), xg, g)  # noqa: E731
        log(f"[silu] {label} on ({x.shape[0]}, {x.shape[1]}) bf16: forward "
            f"{cs.median_ms(torch, fwd, 20):.4f} ms, forward and backward "
            f"{cs.median_ms(torch, bwd, 20):.4f} ms")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    ds = TokenStream(n_docs=cs.LM_BATCH, seq_len=cs.LM_SEQ, vocab_size=cfg.vocab_size)
    batch = to_device(ds.batch(np.arange(cs.LM_BATCH)), dev)
    opt = adamw(warmup_cosine(1e-4, 2, 100))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    times = {k: [] for k in forms}
    try:
        for rnd in range(4):  # A, B, A, B
            label = list(forms)[rnd % 2]
            layers._ACTIVATIONS["silu"] = forms[label]
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                torch.cuda.synchronize()
                if i:  # the first step of a round warms up
                    times[label].append(time.perf_counter() - t0)
    finally:
        layers._ACTIVATIONS["silu"] = own
    for label, t in times.items():
        log(f"[silu] {cfg.name} ({cfg.n_layers} layers), a training step of {cs.LM_BATCH}×"
            f"{cs.LM_SEQ} tokens with {label}: median {statistics.median(t):.4f} s of {len(t)} "
            f"(min {min(t):.4f}, max {max(t):.4f})")


def _ce_composed(h_c, unembed, y_c, valid_v):
    """The CE chunk as it runs on a mesh (logsumexp composed as
    ``model._LogSumExp``, the gold logit by a one-hot reduce), on plain
    tensors (the form ``--ce-probe`` times against)."""
    import torch

    from repro_torch.models import model

    logits = (h_c.to(model.COMPUTE_DTYPE) @ unembed.to(model.COMPUTE_DTYPE).T).float()
    V = logits.shape[-1]
    vocab = torch.arange(V, device=logits.device)
    if valid_v is not None and valid_v < V:
        logits = logits + torch.where(vocab < valid_v, 0.0, -1e30)
    hit = vocab == y_c.long()[..., None]
    return model._LogSumExp.apply(logits) - torch.sum(torch.where(hit, logits, 0.0), dim=-1)


def ce_probe(torch, cs) -> None:
    import statistics
    import time

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, to_device
    from repro_torch.models import init_params, model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    cfg = get_config(cs.LM_ARCH)
    shipped = model._ce_chunk
    forms = {"torch.logsumexp, gather gold (shipped)": shipped,
             "composed, one-hot gold (the mesh path's)": _ce_composed}
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    ds = TokenStream(n_docs=cs.LM_BATCH, seq_len=cs.LM_SEQ, vocab_size=cfg.vocab_size)
    batch = to_device(ds.batch(np.arange(cs.LM_BATCH)), dev)
    # one chunk alone at the main-path shape, forward and backward
    chunk = cfg.logit_chunk if cs.LM_SEQ % cfg.logit_chunk == 0 else cs.LM_SEQ
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(cs.LM_BATCH, chunk, cfg.d_model, device=dev, generator=gen)
    h = h.to(model.COMPUTE_DTYPE).requires_grad_(True)
    y = batch["labels"][:, :chunk]
    w = model.unembed_matrix(params)
    for label, fn in forms.items():
        fwd = lambda: fn(h, w, y, cfg.vocab_size)  # noqa: E731
        g = torch.ones(cs.LM_BATCH, chunk, device=dev)
        bwd = lambda: torch.autograd.grad(fn(h, w, y, cfg.vocab_size), h, g)  # noqa: E731
        log(f"[ce] {label}, one chunk ({cs.LM_BATCH}, {chunk}) × V {w.shape[0]}: forward "
            f"{cs.median_ms(torch, fwd, 20):.4f} ms, forward and backward "
            f"{cs.median_ms(torch, bwd, 20):.4f} ms")
    with torch.no_grad():
        losses = {}
        for label, fn in forms.items():
            model._ce_chunk = fn
            losses[label] = model.loss_fn(params, cfg, batch)[0]
        model._ce_chunk = shipped
    a, b = losses.values()
    log(f"[ce] loss of one forward: {float(a)!r} and {float(b)!r}, "
        f"equal: {bool(torch.equal(a, b))}")
    opt = adamw(warmup_cosine(1e-4, 2, 100))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    times = {k: [] for k in forms}
    peaks = {k: [] for k in forms}
    try:
        for rnd in range(4):  # A, B, A, B
            label = list(forms)[rnd % 2]
            model._ce_chunk = forms[label]
            torch.cuda.reset_peak_memory_stats()
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                torch.cuda.synchronize()
                if i:  # the first step of a round warms up
                    times[label].append(time.perf_counter() - t0)
            peaks[label].append(torch.cuda.max_memory_allocated() / 1e9)
    finally:
        model._ce_chunk = shipped
    for label, t in times.items():
        log(f"[ce] {cfg.name} ({cfg.n_layers} layers), a training step of {cs.LM_BATCH}×"
            f"{cs.LM_SEQ} tokens with {label}: median {statistics.median(t):.4f} s of {len(t)} "
            f"(min {min(t):.4f}, max {max(t):.4f}), peak {max(peaks[label]):.3f} GB")


def count_ops(torch) -> None:
    """The PyTorch dispatcher calls (``aten::`` ops, nested ones included,
    counted by ``torch.profiler``) of one decode step of each xLSTM layer
    kind and of one sLSTM scan step, at xlstm-1.3b's smoke width on the
    CPU: what the host dispatches, whatever the width."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import smoke_config
    from repro_torch.models import blocks, recurrent as rec

    cfg = smoke_config("xlstm-1.3b")
    sc, mc = blocks.slstm_config(cfg), blocks.mlstm_config(cfg)
    gen, cpu = torch.Generator().manual_seed(0), torch.device("cpu")
    ps, pm = rec.init_slstm(sc, gen, cpu), rec.init_mlstm(mc, gen, cpu)
    x = torch.randn(2, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    wx = torch.randn(2, 4 * sc.n_heads * sc.d_head, generator=gen)
    ss, ms = rec.init_slstm_state(sc, 2, cpu), rec.init_mlstm_state(mc, 2, cpu)
    runs = {
        "sLSTM scan step (_slstm_step)": lambda: rec._slstm_step(ps, sc, ss, wx),
        "sLSTM decode step": lambda: rec.slstm_decode(ps, sc, x, ss),
        "mLSTM decode step": lambda: rec.mlstm_decode(pm, mc, x, ms),
    }
    with torch.no_grad():
        for name, fn in runs.items():
            fn()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fn()
            n = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
            log(f"[ops] {name}: {n} dispatcher calls (CPU, torch {torch.__version__})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--ablate-ring", action="store_true")
    ap.add_argument("--ce-baseline", type=Path)
    ap.add_argument("--fl-baseline", type=Path)
    ap.add_argument("--l2-baseline", type=Path)
    ap.add_argument("--topk-baseline", type=Path)
    ap.add_argument("--replay-baseline", type=Path)
    ap.add_argument("--twin-baseline", type=Path, nargs="+")
    ap.add_argument("--lr-probe", action="store_true")
    ap.add_argument("--serve-probe", nargs="*", metavar="ARCH")
    ap.add_argument("--count-ops", action="store_true")
    ap.add_argument("--silu-probe", action="store_true")
    ap.add_argument("--ce-probe", action="store_true")
    args = ap.parse_args()
    import torch

    if args.count_ops:  # on the CPU: a count, not a time
        sys.path.insert(0, str(ROOT / "src"))
        count_ops(torch)
        return
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
    if args.l2_baseline:
        l2_baseline(torch, cs, args.l2_baseline)
    if args.twin_baseline:
        twin_baseline(torch, cs, args.twin_baseline)
    if args.lr_probe:
        lr_probe(torch, cs)
    if args.serve_probe is not None:
        serve_probe(torch, cs, args.serve_probe)
    if args.silu_probe:
        silu_probe(torch, cs)
    if args.ce_probe:
        ce_probe(torch, cs)


if __name__ == "__main__":
    main()
