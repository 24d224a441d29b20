#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA card, the way a user would call
it, and checks each hand-written CUDA kernel against its plain-torch
version:

  0. preconditions: a CUDA card (else exit non-zero, no result); TF32 off;
     the card's name and power limit from nvidia-smi;
  1. build: one nvcc per ``src/repro_torch/kernels/csrc/*.cu``, all started
     together;
  2. kernels: ``fl_gains`` and ``fl_gains_argmax`` (fp32 and bf16 tiles)
     against their plain versions at ragged shapes and at both main-path
     pool sizes, then timed with CUDA events at the main-path shape beside
     their plain versions and bounds; ``ce_proxy`` (bf16 and fp32) against
     its plain version at T = 4,096, D = 2048, V = 151,936 and at ragged
     shapes, then timed the same way;
  3. select: per-class CRAIG (fraction 0.1, engine='auto') on an
     Ijcnn1-shaped pool (49,990 × 22, two classes of 33,216 and 16,774) —
     the ``device`` engine, one ``fl_gains_argmax`` launch per greedy round —
     held to the same selection with the plain sweep; then a reduced pool
     through the ``device`` and ``features`` engines, kernel against plain
     sweep, and the q > 1 lazy path's host syncs;
  4. train: weighted incremental gradient (paper Eq. 20) on the CRAIG
     coreset, a random subset and the full data;
  5. LM proxies at qwen3-1.7b width: ``proxy_features_fused`` (the
     ``ce_proxy`` kernel) against ``proxy_features`` (the einsum path) on one
     8 × 512 batch of a seeded model, both timed, whole and head alone;
  6. LM coreset training, the slice-2 main path: ``Trainer.run`` at
     qwen3-1.7b width on the seeded token stream, with per-epoch CRAIG
     refresh through the ``ce_proxy`` kernel — inline refreshes (timed
     apart), then the default asynchronous refresh, whose epoch-0 losses
     must match;
  7. Covtype-shaped selection, slice 3's first path: per-class CRAIG
     (fraction 0.1, engine='auto') on 581,012 × 54 points in seven classes
     — the ``sparse`` engine: a ``topk_sim`` graph per class, the host lazy
     greedy, the exact γ through ``pairwise_l2`` — then weighted IG on the
     coreset; the class-0 graph held to the plain twin's, the smallest
     class selected through both routes; ``topk_sim`` and ``pairwise_l2``
     timed at the path's shapes (``torch.cdist`` beside ``pairwise_l2``);
  8. the streaming coreset service, slice 3's second path:
     ``CoresetService(budget=1024, dim=2048)`` fed 16 seeded deltas of
     4,096 rows, every finalize through ``fl_replay``, the four installed
     selections held to the dense finalize; ``fl_replay`` timed at the
     service's shape; a ``launch/serve.py --coreset --device cuda`` round
     trip in a subprocess;
  9. the report: one JSON line per the six kernels, then the last line,
     {"ok": true, "device": {...}}.

Before phases 2–8, ``kernels`` compares ``topk_sim``, ``pairwise_l2`` and
``fl_replay`` with their plain versions at ragged shapes.

Any failure raises and exits non-zero.  Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_MAIN, D_MAIN = 49_990, 22
CLASS_SIZES = {0: 33_216, 1: 16_774}
BUDGETS = {0: 3_322, 1: 1_677}
N_REDUCED = 6_144  # ≈ 4,096 points in the larger class
LAM = 1e-5
TRAIN_EPOCHS = 2
CHECK_SIZES = (1, 7, 129, 1000, *CLASS_SIZES.values())
CHECK_DIMS = (1, 22, 54, 130, 257)  # 257: past fl_gains.cu's 64-wide resident cap
TIMED_LAUNCHES = 25

# LM phases: qwen3-1.7b at full width on the seeded token stream.
LM_ARCH = "qwen3-1.7b"
LM_DOCS, LM_SEQ, LM_BATCH = 512, 512, 8
LM_FRACTION = 0.3
# 64 full-data steps (epoch 0; selection v1 at step 0), 19 steps on the
# first coreset (epoch 1; v1 installed, v2 selected at step 64), and the
# first step of epoch 2 (v2 installed, v3 selected): three refreshes.
LM_STEPS = 84
# The asynchronous run: epoch 0 while v1 is selected in the background,
# then the install of v1 (and v2 started) at step 64.
LM_ASYNC_STEPS = 65
CE_SHAPES = (  # (T, D, V, valid_v): main-path shape, then ragged ones
    (4096, 2048, 151_936, 151_936),
    # the same with valid_v at qwen3's tokenizer vocabulary (the config pads
    # the tables to 151,936 and phase 5 runs valid_v = 151,936): a ragged
    # last valid vocab block
    (4096, 2048, 151_936, 151_669),
    (1000, 96, 1000, 997),
    (1000, 72, 1000, 997),
    # the bf16 kernel's tiling edges: one token at the widest D; D not a
    # multiple of 256 with ragged T and V; D % 8 != 0 (the staged route)
    (1, 2048, 4099, 4097),
    (129, 2040, 4099, 4097),
    (37, 250, 3001, 2999),
)
CE_TIMED = {"bfloat16": 5, "float32": 3}  # CUDA-event-timed launches
PROXY_TIMED = 5  # CUDA-event-timed calls of each proxy path at full width
# Device memory still allocated after a trainer is deleted; its parameters
# alone are 8.1 GB.
FREED_GB = 4.0

# Slice 3, path 1: the Covtype-shaped pool (paper §5.1's Covtype is
# 581,012 × 54 in seven classes; the real file is not in the repository).
COV_N, COV_D, COV_CLASSES = 581_012, 54, 7
COV_SIZES = {0: 223_780, 1: 112_297, 2: 74_513, 3: 56_464, 4: 44_663, 5: 37_146, 6: 32_149}
COV_BUDGETS = {0: 22_378, 1: 11_230, 2: 7_451, 3: 5_646, 4: 4_466, 5: 3_715, 6: 3_215}
COV_K = 64  # SparseConfig().k
TOPK_CHECKS = ((1, 1, 1), (37, 5, 7), (130, 12, 23), (300, 33, 64), (1000, 54, 64),
               (4099, 3, 33), (2000, 130, 100), (5000, 54, 128))  # (n, d, k)
PAIR_CHECKS = ((1, 1, 1), (37, 5, 3), (130, 129, 22), (999, 1001, 7), (1000, 777, 54))
REPLAY_CHECKS = ((1, 1, 1), (37, 5, 3), (130, 129, 22), (1000, 300, 54), (3000, 1024, 2048))
# Slice 3, path 2: the streaming coreset service at the width of the
# qwen3-1.7b proxies (ce_proxy's D); eps = 0.15 gives 56 sieves.
SVC_BUDGET, SVC_DIM, SVC_DELTAS, SVC_ROWS, SVC_CLUSTERS = 1024, 2048, 16, 4096, 64
SVC_INSTALL_AT = (4, 8, 12, 16)

# Published dense peaks (NVIDIA data sheet, H100 SXM): fp32 on the CUDA
# cores, bf16 on the tensor cores, and device-memory bandwidth, keyed by
# the card's name.
PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 989e12, 3.35e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple[float, float, float]:
    if name not in PEAKS:
        raise RuntimeError(f"no published peaks recorded for {name!r}")
    return PEAKS[name]


def median_ms(torch, fn, reps: int = TIMED_LAUNCHES, warm: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed calls after ``warm`` warm-ups."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm, MHz)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return 1e6 * float(proc.stdout.strip().splitlines()[0])


# Issue slots per (row, candidate) pair of fl_gains.cu, counted from its
# source: per feature dim one FFMA plus the shared loads (8 LDS.64 + 2
# LDS.128 per two dims of 32 pairs, 10/64 a pair-dim), and an epilogue of
# ~14 (norm sum, −2·dot, max, the IEEE sqrtf sequence of ~8, subtract,
# relu, accumulate).
FL_SLOTS_PER_DIM = 1.0 + 10.0 / 64.0
FL_SLOTS_EPILOGUE = 14.0


def issue_seconds(torch, n: int, m: int, d: int, sm_clock: float) -> float:
    """fl_gains' instruction-issue bound: the pairs' issue slots over the
    card's warp-instruction rate (4 schedulers an SM, one warp instruction
    of 32 threads each per clock, at the maximum SM clock)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = n * m * (d * FL_SLOTS_PER_DIM + FL_SLOTS_EPILOGUE) / 32.0
    return slots / (sms * 4 * sm_clock)


def gain_tol(x, n: int, d_max: float, bf16: bool) -> float:
    """rtol-free part of the gains tolerance: self-distance rounding
    (4·√ε₃₂·max‖x‖, ~√ε₃₂·‖x‖ per self pair in any dot order), fp32
    summation over n rows of terms ≤ d_max, and bf16 rounding of the tiles."""
    import torch

    eps = torch.finfo(torch.float32).eps
    norm = float(torch.linalg.norm(x, dim=1).max())
    tol = 4.0 * math.sqrt(eps) * norm + 8.0 * n * eps * d_max
    if bf16:
        tol += 4.0 * math.sqrt(2.0**-8) * norm
    return tol


def compare_selections(torch, parity, label, a, b, x, y) -> dict:
    """Hold selection ``a`` (kernel) to ``b`` (plain sweep), class by class,
    under the tie rule of ``repro_torch.parity``: identical indices up to
    the first divergence, a near-tie there, then fp64 objectives within
    1e-3; identical indices and γ when nothing diverged.  Returns
    ``{class: divergence position}``."""
    import numpy as np

    diverged = {}
    for c in np.unique(y):
        pool = np.nonzero(y == c)[0]
        members = set(pool.tolist())
        ia = [int(np.searchsorted(pool, i)) for i in a.indices if int(i) in members]
        ib = [int(np.searchsorted(pool, i)) for i in b.indices if int(i) in members]
        xc = x[torch.as_tensor(pool, device=x.device)]
        t = parity.first_divergence(xc, ia, ib, parity.tie_tolerance(xc))
        if t is not None:
            ca, cb = parity.coverage64(xc, ia), parity.coverage64(xc, ib)
            if abs(ca - cb) > 1e-3 * ca:
                raise AssertionError(f"{label} class {c}: objective {ca} vs {cb}")
            diverged[int(c)] = t
    if not diverged and not (np.array_equal(a.indices, b.indices)
                             and np.array_equal(a.weights, b.weights)):
        raise AssertionError(f"{label}: kernel and plain selections differ")
    return diverged


def verdict(diverged: dict) -> str:
    return ("identical indices and γ" if not diverged else
            f"near-tie divergence at {diverged} (tie rule), objective within 1e-3")


def ce_tol(w, dtype: str) -> float:
    """Tolerance of ``ce_proxy`` against its plain version.  g is a convex
    combination of W rows minus a W row, so errors scale with max|W|.
    bf16: one bf16 ulp (2⁻⁸) of max|W| — a p value whose fp32 exp differs
    in the last bit may round to the neighbouring bf16 value.  fp32: the
    softmax sums run over V ≈ 1.5·10⁵ terms in another order, a relative
    error of about √V·ε₃₂ ≈ 5·10⁻⁵: 1e-4·max|W|."""
    wmax = float(w.abs().max())
    return (2.0**-8 if dtype == "bfloat16" else 1e-4) * wmax


def check_ce_proxy(torch, ops, kce, dev, gen, peaks) -> dict:
    """``ce_proxy`` kernel against its plain version in both dtypes at every
    shape of CE_SHAPES (labels include the last valid column), then CUDA-event
    times at the main-path shape.  Returns the report entry (bf16, the main
    path's dtype) and logs the fp32 figures beside it."""
    fp32_peak, bf16_peak, mem_bw = peaks
    max_err = {"bfloat16": 0.0, "float32": 0.0}
    timed = {}
    for T, D, V, vv in CE_SHAPES:
        h = torch.randn(T, D, device=dev, generator=gen)
        w = 0.05 * torch.randn(V, D, device=dev, generator=gen)
        y = torch.randint(0, vv, (T,), device=dev, generator=gen)
        y[-1] = vv - 1
        y[0] = vv - 1
        for dname in ("bfloat16", "float32"):
            cd = getattr(torch, dname)
            before = ops.LAUNCHES["ce_proxy"]
            got = ops.ce_proxy(h, w, y, valid_v=vv, compute_dtype=cd, impl="cuda")
            torch.cuda.synchronize()
            if ops.LAUNCHES["ce_proxy"] != before + 1:
                raise AssertionError("ce_proxy launch counter did not advance")
            want = ops.ce_proxy(h, w, y, valid_v=vv, compute_dtype=cd, impl="torch")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"ce_proxy {dname} T={T} D={D} V={V}: non-finite output")
            err = float((got - want).abs().max())
            tol = ce_tol(w, dname)
            if err > tol:
                raise AssertionError(f"ce_proxy {dname} T={T} D={D} V={V} valid_v={vv}: "
                                     f"max |err| {err} > {tol}")
            max_err[dname] = max(max_err[dname], err)
            log(f"[2] ce_proxy {dname} T={T} D={D} V={V} valid_v={vv}: max |err| "
                f"{err:.3e} (tol {tol:.3e})")
        if (T, D, V, vv) != CE_SHAPES[0]:
            continue
        for dname, reps in CE_TIMED.items():
            cd = getattr(torch, dname)
            hc, wc, yc = h.to(cd), w.to(cd), y.to(torch.int32)
            es = 2 if dname == "bfloat16" else 4
            t_ops = 4.0 * T * V * D / (bf16_peak if dname == "bfloat16" else fp32_peak)
            t_bytes = (es * (T * D + V * D) + 4 * T + 4 * T * D) / mem_bw
            timed[dname] = {
                "ms": median_ms(torch, lambda: kce.ce_proxy_cuda(hc, wc, yc, vv), reps),
                "plain_ms": median_ms(torch, lambda: kce.ce_proxy_torch(h, w, y, vv, cd), reps),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            log(f"[2] ce_proxy {dname} at T={T}, D={D}, V={V}: {timed[dname]}")
    return {**timed["bfloat16"], "max_abs_err": max_err["bfloat16"],
            "fp32": {**timed["float32"], "max_abs_err": max_err["float32"]}}


def full_width_proxy_check(torch, ops, card, dev) -> None:
    """qwen3-1.7b at full width, seeded on the card: the fused proxy (the
    ``ce_proxy`` kernel, bf16) against the einsum path on one 8 × 512 batch.
    Tolerance 2⁻⁵·max|W|: the einsum path also rounds its logits and its
    (p − y) to bf16 where the kernel keeps fp32 (a few bf16 ulps of a
    convex combination of W rows).  Then both paths are timed per batch,
    whole (forward included) and head alone (on the same hidden states)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.proxy import lm_unembed_input_proxy
    from repro_torch.data import TokenStream, to_device
    from repro_torch.models import (COMPUTE_DTYPE, forward, init_params, proxy_features,
                                    proxy_features_fused, unembed_matrix)

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    # param_count() counts the real vocabulary; the tables hold padded rows
    expected = cfg.param_count() + 2 * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    if n_params != expected:
        raise AssertionError(f"{n_params} parameters, config says {expected}")
    ds = TokenStream(n_docs=LM_DOCS, seq_len=LM_SEQ, vocab_size=cfg.vocab_size)
    batch = to_device(ds.batch(np.arange(LM_BATCH)), dev)
    fused = proxy_features_fused(params, cfg, batch)
    einsum = proxy_features(params, cfg, batch)
    torch.cuda.synchronize()
    err = float((fused - einsum).abs().max())
    tol = 2.0**-5 * float(params["unembed"].abs().max())
    if fused.shape != (LM_BATCH, cfg.d_model) or not bool(torch.isfinite(fused).all()):
        raise AssertionError(f"fused proxies: shape {tuple(fused.shape)} or non-finite")
    if err > tol:
        raise AssertionError(f"fused against einsum proxies: max |err| {err} > {tol}")
    log(f"[5] {LM_ARCH} ({n_params:,} params, seeded on the card): fused proxies "
        f"{tuple(fused.shape)} against einsum, max |err| {err:.3e} (tol {tol:.3e}, "
        f"max|g| {float(einsum.abs().max()):.3e}); {time.perf_counter() - t0:.1f}s; {card}")
    with torch.no_grad():
        hidden, _ = forward(params, cfg, batch)
        w, labels = unembed_matrix(params), batch["labels"]
        h2, y2 = hidden.reshape(-1, cfg.d_model), labels.reshape(-1)
        ms = {
            "fused (kernel)": lambda: proxy_features_fused(params, cfg, batch),
            "einsum": lambda: proxy_features(params, cfg, batch),
            "kernel head": lambda: ops.ce_proxy(
                h2, w, y2, valid_v=cfg.vocab_size, compute_dtype=COMPUTE_DTYPE, impl="cuda"),
            "einsum head": lambda: lm_unembed_input_proxy(
                hidden, w, labels, chunk=cfg.logit_chunk, valid_v=cfg.vocab_size,
                compute_dtype=COMPUTE_DTYPE),
        }
        ms = {k: round(median_ms(torch, fn, PROXY_TIMED), 3) for k, fn in ms.items()}
    log(f"[5] {LM_ARCH} proxies per {LM_BATCH}×{LM_SEQ} batch, median ms of {PROXY_TIMED} "
        f"(whole = forward + head): {ms}; {card}")
    log(f"[5] head alone at T = {LM_BATCH * LM_SEQ} tokens, D = {cfg.d_model}, V = "
        f"{cfg.padded_vocab}: ce_proxy kernel {ms['kernel head']} ms, einsum head "
        f"{ms['einsum head']} ms ({ms['kernel head'] / ms['einsum head']:.2f}×); {card}")
    del params, fused, einsum, batch, hidden, w, labels, h2, y2
    torch.cuda.empty_cache()


def train_lm(torch, ops, card, dev, mode: str, n_steps: int, expect: tuple,
             tag: str) -> dict:
    """``Trainer.run`` at qwen3-1.7b width with per-epoch CRAIG refresh.
    Counts are zeroed just before the run and read just after.  ``expect``
    is (refreshes, installs).  With ``mode='sync'`` the refreshes run
    inline, so step, extraction and selection seconds are measured apart;
    with ``'async'`` extraction overlaps training (the trainer's default),
    and each install reports how long its step waited for the selection.
    Returns the run's losses and launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.craig import CraigConfig
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(LM_ARCH)
    ds = TokenStream(n_docs=LM_DOCS, seq_len=LM_SEQ, vocab_size=cfg.vocab_size)
    pool_batches = LM_DOCS // LM_BATCH
    tcfg = TrainerConfig(
        batch_size=LM_BATCH, select_every_epochs=1,
        craig=CraigConfig(fraction=LM_FRACTION, per_class=False),
        proxy_pool_batches=pool_batches, refresh_mode=mode,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    trainer = Trainer(cfg, tcfg, ds, adamw(warmup_cosine(3e-4, 10, LM_STEPS)),
                      lambda: init_params(cfg, gen), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    log_ = trainer.run(n_steps)
    trainer.refresher.wait()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = [m for m in log_ if m["event"] == "step"]
    installs = [m for m in log_ if m["event"] == "craig_refresh"]
    pending = trainer.sampler._pending
    n_refresh = trainer.refresher.version
    losses = [m["loss"] for m in steps]
    if len(steps) != n_steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: {len(steps)} steps, losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: loss did not fall: {losses[0]} → {losses[-1]}")
    if (n_refresh, len(installs)) != expect or pending is None:
        raise AssertionError(f"{tag}: {n_refresh} refreshes, {len(installs)} installs, "
                             f"pending {pending is not None}; expected {expect}, one staged")
    sums = [m["weight_sum"] for m in installs]
    sums.append(float(np.sum(pending["weights"], dtype=np.float64)))
    if any(abs(v - LM_DOCS) > 1e-3 for v in sums):
        raise AssertionError(f"{tag}: Σγ per published selection {sums}, expected {LM_DOCS}")
    if launches["ce_proxy"] != n_refresh * pool_batches:
        raise AssertionError(f"{tag}: ce_proxy launched {launches}; expected "
                             f"{pool_batches} per refresh × {n_refresh}")
    step_s = statistics.median(m["time_s"] for m in steps[2:])
    refreshes = installs + [{"version": pending["version"], **pending["meta"]}]
    per = [(r["version"], round(r["extract_time_s"], 3), round(r["selection_time_s"], 3))
           for r in refreshes]
    stalls = [round(m["install_stall_s"], 3) for m in installs]
    log(f"[6] {tag}: {LM_ARCH} Trainer.run, refresh_mode={mode!r}: {n_steps} steps of "
        f"{LM_BATCH}×{LM_SEQ} tokens in {total_s:.1f}s; loss {losses[0]:.4f} → "
        f"{losses[-1]:.4f}; coreset {installs[-1]['coreset_size']}/{LM_DOCS} docs; Σγ per "
        f"published selection {sums}; launches {launches}")
    log(f"[6] {tag}: median {step_s:.4f} s/step ({LM_BATCH * LM_SEQ / step_s:.0f} "
        f"tokens/s); per refresh (version, extract s, select s): {per}; install stalls "
        f"{stalls} s; max_memory_allocated {peak_gb:.2f} GB; {card}")
    del trainer
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    if left_gb > FREED_GB:
        raise AssertionError(f"{tag}: {left_gb:.2f} GB still allocated after the "
                             "trainer was deleted")
    return {"losses": losses, "launches": launches["ce_proxy"]}


def bound(t_ops: float, t_bytes: float) -> dict:
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def d2_rounding(torch, d: int) -> float:
    """Relative fp32 rounding of ‖x‖² + ‖y‖² − 2·x·y over a d-long dot
    product in another order: 4·√d·ε₃₂ (d roundings add up like a random
    walk; ×4 of margin)."""
    return 4.0 * math.sqrt(max(d, 1)) * torch.finfo(torch.float32).eps


def dist_tol(torch, x) -> float:
    """The self-distance rounding of √(‖x‖²+‖y‖²−2x·y): the root of
    ``d2_rounding``·2·max‖x‖² (a distance near 0 takes the root of the
    error); distances away from 0 round far inside it."""
    return (math.sqrt(2.0 * d2_rounding(torch, x.shape[1]))
            * float(torch.linalg.norm(x, dim=1).max()))


def hold_gains(torch, g, pg, tol, what: str) -> float:
    """Hold each replayed gain to its plain value on its own: |g − pg| ≤ tol
    + 1e-3·|pg|.  tol is the distance rounding (``dist_tol``: a gain sums
    distance differences, and the largest ones sit at self-distances near
    0); 1e-3 is the relative bound, twice the 4.8e-4 by which the
    reference's own blocked jnp replay differs from its dense one.  Returns
    the max |g − pg|.  A NaN gain is out of bound."""
    err = (g - pg).abs()
    bad = torch.nonzero(~(err <= tol + 1e-3 * pg.abs()))[:, 0]
    if bad.numel():
        t = int(bad[0])
        raise AssertionError(f"{what}: {bad.numel()} of {g.numel()} gains out of bound, "
                             f"the first at {t}: {float(g[t])} against {float(pg[t])}")
    return float(err.max())


def compare_graphs(torch, x, got, want, tol) -> tuple[float, int]:
    """Hold a top-k graph to another: values within ``tol`` (+1e-5 rel);
    a differing index only where the two columns' fp64 similarities are
    within ``tol`` (the tie rule).  Returns (max |Δvals|, differing slots)."""
    gv, gi = got
    wv, wi = want
    err = float((gv - wv).abs().max())
    if err > tol + 1e-5 * float(wv.abs().max()):
        raise AssertionError(f"graph values differ by {err} > {tol}")
    rows, cols = torch.nonzero(gi != wi, as_tuple=True)
    if rows.numel():
        xr = x[rows].double()
        gap = (torch.linalg.norm(xr - x[gi[rows, cols].long()].double(), dim=1)
               - torch.linalg.norm(xr - x[wi[rows, cols].long()].double(), dim=1)).abs()
        if float(gap.max()) > tol:
            raise AssertionError(f"graph index differs at a gap {float(gap.max())} > {tol}")
    return err, int(rows.numel())


def check_slice3_kernels(torch, ops, dev, gen) -> dict:
    """``topk_sim``, ``pairwise_l2`` and ``fl_replay`` against their plain
    versions at ragged shapes.  Returns the max |err| of each."""
    err = {"topk_sim": 0.0, "pairwise_l2": 0.0, "fl_replay": 0.0}
    for n, d, k in TOPK_CHECKS:
        x = torch.randn(n, d, device=dev, generator=gen)
        before = ops.LAUNCHES["topk_sim"]
        got = ops.topk_sim(x, k, impl="cuda")
        torch.cuda.synchronize()
        if ops.LAUNCHES["topk_sim"] != before + 1:
            raise AssertionError("topk_sim launch counter did not advance")
        e, diff = compare_graphs(torch, x, got, ops.topk_sim(x, k, impl="torch"),
                                 dist_tol(torch, x))
        err["topk_sim"] = max(err["topk_sim"], e)
        log(f"[2] topk_sim n={n} d={d} k={k}: max |Δvals| {e:.3e}, {diff} index slots "
            "differ (near-ties)")
    for n, m, d in PAIR_CHECKS:
        x = torch.randn(n, d, device=dev, generator=gen)
        y = torch.randn(m, d, device=dev, generator=gen)
        before = ops.LAUNCHES["pairwise_l2"]
        got = ops.pairwise_l2(x, y, impl="cuda")
        torch.cuda.synchronize()
        if ops.LAUNCHES["pairwise_l2"] != before + 1:
            raise AssertionError("pairwise_l2 launch counter did not advance")
        e = float((got - ops.pairwise_l2(x, y, impl="torch")).abs().max())
        tol = dist_tol(torch, torch.cat([x, y]))
        if e > tol:
            raise AssertionError(f"pairwise_l2 n={n} m={m} d={d}: max |err| {e} > {tol}")
        err["pairwise_l2"] = max(err["pairwise_l2"], e)
    log(f"[2] pairwise_l2 at (n, m, d) in {PAIR_CHECKS}: max |err| {err['pairwise_l2']:.3e}")
    for n, m, d in REPLAY_CHECKS:
        x = torch.randn(n, d, device=dev, generator=gen)
        e_rows = torch.randperm(n, device=dev, generator=gen)[:m]
        e = x[e_rows]
        valid = torch.rand(m, device=dev, generator=gen) < 0.9
        valid[0] = True
        cur0 = torch.rand(n, device=dev, generator=gen)
        d_max = 2.0 * torch.sqrt(torch.sum(x * x, dim=1).max()) + 1e-6
        before = ops.LAUNCHES["fl_replay"]
        g, cur, bv, bi = ops.fl_replay(x, e, valid, cur0, d_max, impl="cuda")
        torch.cuda.synchronize()
        if ops.LAUNCHES["fl_replay"] != before + 1:
            raise AssertionError("fl_replay launch counter did not advance")
        pg, pcur, pbv, pbi = ops.fl_replay(x, e, valid, cur0, d_max, impl="torch")
        tol = dist_tol(torch, x)
        gerr = hold_gains(torch, g, pg, tol, f"fl_replay n={n} m={m} d={d}")
        if float((cur - pcur).abs().max()) > tol or float((bv - pbv).abs().max()) > tol:
            raise AssertionError(f"fl_replay n={n} m={m} d={d}: cover or best value differs")
        flips = torch.nonzero(bi != pbi)[:, 0]
        if flips.numel():  # the tie rule on the best position
            xr = x[flips].double()
            gap = (torch.linalg.norm(xr - e[bi[flips].long()].double(), dim=1)
                   - torch.linalg.norm(xr - e[pbi[flips].long()].double(), dim=1)).abs()
            if float(gap.max()) > tol:
                raise AssertionError(f"fl_replay n={n} m={m} d={d}: best position differs")
        err["fl_replay"] = max(err["fl_replay"], gerr)
        log(f"[2] fl_replay n={n} m={m} d={d}: max |Δgain| {gerr:.3e}, "
            f"{flips.numel()} best positions differ (near-ties)")
    return err


def coverage64(torch, x, idx, block: int = 8192) -> float:
    """L(S) = Σ_i min_{j∈S} ‖x_i − x_j‖ in fp64, row block by row block."""
    xs = x[torch.as_tensor(idx, device=x.device)].double()
    return sum(float(torch.cdist(x[lo:lo + block].double(), xs).min(dim=1).values.sum())
               for lo in range(0, x.shape[0], block))


def covtype_selection(torch, ops, card, dev, peaks) -> dict:
    """Slice 3's first path: per-class CRAIG on the Covtype-shaped pool with
    engine='auto' (the sparse engine), then two epochs of weighted IG.
    Returns the report entries of ``topk_sim`` and ``pairwise_l2``."""
    import numpy as np

    from repro_torch.core import engines as E
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.engines import sparse
    from repro_torch.core.proxy import convex_feature_proxy
    from repro_torch.data.synthetic import make_classification
    from repro_torch.examples.quickstart import logistic, schedule_for
    from repro_torch.kernels import pairwise_l2 as kpw, topk_sim as ktk
    from repro_torch.optim import ig_run

    fp32_peak, _, mem_bw = peaks
    x_np, y = make_classification(COV_N, COV_D, COV_CLASSES, seed=0)
    x_np = x_np / np.abs(x_np).max()
    if {int(c): int(k) for c, k in zip(*np.unique(y, return_counts=True))} != COV_SIZES:
        raise AssertionError("make_classification no longer gives the Covtype-shaped sizes")
    feats = convex_feature_proxy(x_np, device=dev)
    selector = CraigSelector(CraigConfig(fraction=0.1, per_class=True), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    for k in sparse.TIMINGS:
        sparse.TIMINGS[k] = 0.0
    t0 = time.perf_counter()
    cs = selector.select(feats, y)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    phases = {k: round(v, 3) for k, v in sparse.TIMINGS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_budget = sum(COV_BUDGETS.values())
    if cs.engine != E.SparseConfig().to_dict():
        raise AssertionError(f"engine='auto' picked {cs.engine}, expected the sparse engine")
    if cs.size != n_budget or len(np.unique(cs.indices)) != cs.size:
        raise AssertionError(f"selected {cs.size} (unique {len(np.unique(cs.indices))}), "
                             f"expected {n_budget}")
    if float(np.sum(cs.weights, dtype=np.float64)) != COV_N:
        raise AssertionError(f"Σγ = {np.sum(cs.weights, dtype=np.float64)} != {COV_N}")
    if cs.per_class_sizes != COV_BUDGETS:
        raise AssertionError(f"per-class sizes {cs.per_class_sizes} != {COV_BUDGETS}")
    if launches["topk_sim"] != COV_CLASSES or launches["pairwise_l2"] < COV_CLASSES:
        raise AssertionError(f"launches {launches}: expected one topk_sim per class and at "
                             "least one pairwise_l2 block per class")
    if not math.isfinite(cs.coverage):
        raise AssertionError(f"coverage {cs.coverage}")
    log(f"[7] Covtype-shaped selection: {cs.size}/{COV_N} medoids, engine {cs.engine}, "
        f"{select_s:.3f}s (graph {phases['graph_s']}s, host greedy {phases['greedy_s']}s, "
        f"assignment {phases['assign_s']}s); launches {launches}; per-class sizes "
        f"{cs.per_class_sizes}; Σγ={np.sum(cs.weights, dtype=np.float64):.0f}; "
        f"L(S)={cs.coverage:.4f}; max_memory_allocated {peak_gb:.2f} GB; {card}")

    # class 0: the kernel's graph against the plain twin's, both timed
    pool0 = torch.as_tensor(np.nonzero(y == 0)[0], device=dev)
    x0 = feats[pool0].contiguous()
    n0 = x0.shape[0]
    sq0 = torch.sum(x0 * x0, dim=1)
    dm0 = 2.0 * torch.sqrt(sq0.max()) + 1e-6
    out = {}
    t_ms = median_ms(torch, lambda: out.__setitem__("k", ktk.topk_sim_cuda(x0, sq0, dm0, COV_K)),
                     3, warm=1)
    p_ms = median_ms(torch, lambda: out.__setitem__("p", ktk.topk_sim_torch(x0, sq0, dm0, COV_K)),
                     1, warm=0)
    tol0 = dist_tol(torch, x0)
    g_err, g_diff = compare_graphs(torch, x0, out["k"], out["p"], tol0)
    del out
    t_ops = n0 * n0 * (2 * COV_D + 6) / fp32_peak  # dot, norms, sqrt, −, compare
    t_bytes = (4 * n0 * (COV_D + 1) + 8 * n0 * COV_K) / mem_bw
    topk = {"ms": t_ms, "plain_ms": p_ms, **bound(t_ops, t_bytes), "library_ms": None,
            "launches": launches["topk_sim"], "max_abs_err_main": g_err}
    log(f"[7] topk_sim at class 0 ({n0} × {COV_D}, k={COV_K}): kernel against plain twin: "
        f"max |Δvals| {g_err:.3e} (tol {tol0:.3e}), {g_diff} of {n0 * COV_K} index slots "
        f"differ (near-ties); {topk}")

    # pairwise_l2 at one class-0 assignment block against its medoids
    sel0 = torch.as_tensor(np.searchsorted(np.nonzero(y == 0)[0],
                                           cs.indices[np.isin(cs.indices, np.nonzero(y == 0)[0])]),
                           device=dev)
    s0 = x0[sel0].contiguous()
    r0 = s0.shape[0]
    rows = min(n0, sparse.ASSIGN_BLOCK_BYTES // (4 * r0))
    xb = x0[:rows].contiguous()
    sqb, sqs = torch.sum(xb * xb, dim=1), torch.sum(s0 * s0, dim=1)
    d_k = kpw.pairwise_l2_cuda(xb, s0, sqb, sqs)
    d_p = kpw.pairwise_l2_torch(xb, s0, sqb, sqs)
    pw_err = float((d_k - d_p).abs().max())
    if pw_err > tol0:
        raise AssertionError(f"pairwise_l2 at the main-path block: max |err| {pw_err} > {tol0}")
    del d_k, d_p
    t_ops = rows * r0 * (2 * COV_D + 4) / fp32_peak
    t_bytes = 4 * (rows * COV_D + r0 * COV_D + rows + r0 + rows * r0) / mem_bw
    pair = {"ms": median_ms(torch, lambda: kpw.pairwise_l2_cuda(xb, s0, sqb, sqs), 10),
            "plain_ms": median_ms(torch, lambda: kpw.pairwise_l2_torch(xb, s0, sqb, sqs), 10),
            **bound(t_ops, t_bytes),
            "library_ms": median_ms(torch, lambda: torch.cdist(xb, s0), 10),
            "launches": launches["pairwise_l2"], "max_abs_err_main": pw_err}
    log(f"[7] pairwise_l2 at one class-0 assignment block ({rows} × {r0} × {COV_D}): {pair}")

    # the smallest class through both routes
    pool6 = np.nonzero(y == 6)[0]
    x6 = feats[torch.as_tensor(pool6, device=dev)]
    runs = {}
    for impl in ("cuda", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[impl] = CraigSelector(CraigConfig(fraction=0.1, per_class=False,
                                               engine=E.SparseConfig(impl=impl)),
                                   device=dev).select(x6)
        torch.cuda.synchronize()
        runs[impl + "_s"] = time.perf_counter() - t0
    a, b = runs["cuda"], runs["torch"]
    if np.array_equal(a.indices, b.indices):
        if not np.array_equal(a.weights, b.weights):
            raise AssertionError("class 6: same medoids, different γ")
        verdict6 = "identical indices and γ"
    else:
        ca, cb = coverage64(torch, x6, a.indices), coverage64(torch, x6, b.indices)
        if abs(ca - cb) > 1e-3 * max(ca, cb):
            raise AssertionError(f"class 6: objectives {ca} and {cb} differ by more than 1e-3")
        verdict6 = f"indices differ after a near-tie; fp64 L(S) {ca:.4f} vs {cb:.4f}"
    log(f"[7] class 6 ({len(pool6)} × {COV_D}, r={a.size}) through both routes: kernels "
        f"{runs['cuda_s']:.3f}s, plain {runs['torch_s']:.3f}s; {verdict6}")

    # two epochs of weighted IG on the coreset: class 0 against the rest
    grad_one, full_loss = logistic(feats, (y == 0).astype(np.int64), LAM)
    sched = schedule_for(COV_N)
    loss0 = full_loss(torch.zeros(COV_D, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_end, _ = ig_run(grad_one, torch.zeros(COV_D, device=dev), cs.indices, cs.weights, sched,
                      TRAIN_EPOCHS)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / TRAIN_EPOCHS
    loss = full_loss(w_end)
    if not (math.isfinite(loss) and loss < loss0):
        raise AssertionError(f"Covtype IG: loss {loss} is not below {loss0}")
    log(f"[7] weighted IG on the Covtype-shaped coreset (class 0 against the rest): "
        f"{cs.size} steps/epoch, {secs:.3f}s/epoch, loss {loss:.6f} after {TRAIN_EPOCHS} "
        f"epochs (w0: {loss0:.6f})")
    return {"topk_sim": topk, "pairwise_l2": pair}


def coreset_service(torch, ops, card, dev, peaks) -> dict:
    """Slice 3's second path: the streaming coreset service on the card.
    Every drain finalizes through ``fl_replay``; the four installed
    selections are held to the dense finalize.  Returns the report entry
    of ``fl_replay``."""
    from repro_torch.core.engines import streaming
    from repro_torch.kernels import fl_gains as kfl
    from repro_torch.serve import CoresetService

    fp32_peak, _, mem_bw = peaks
    gen = torch.Generator(device=dev).manual_seed(1)
    centers = torch.randn(SVC_CLUSTERS, SVC_DIM, device=dev, generator=gen)
    deltas = []
    for _ in range(SVC_DELTAS):
        comp = torch.randint(0, SVC_CLUSTERS, (SVC_ROWS,), device=dev, generator=gen)
        deltas.append(centers[comp] + 0.5 * torch.randn(SVC_ROWS, SVC_DIM, device=dev,
                                                        generator=gen))
    svc = CoresetService(SVC_BUDGET, SVC_DIM, mode="sync", device=dev)
    sel = svc.selector
    L = streaming.num_sieves(SVC_BUDGET, sel.config.eps)
    ingest_s, final_s, results = [], [], []
    ingest, result = sel.ingest, sel.result

    def timed(fn, sink, keep=None):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            if keep is not None:
                keep.append(out)
            return out
        return call

    sel.ingest = timed(ingest, ingest_s)
    sel.result = timed(result, final_s, results)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t_run = time.perf_counter()
    updates, checks, check_s = [], [], 0.0
    for i, d in enumerate(deltas, start=1):
        if svc.submit_delta(d) != i:
            raise AssertionError(f"delta {i} drained as another version")
        if i not in SVC_INSTALL_AT:
            continue
        u = svc.coreset()
        t0 = time.perf_counter()
        pool = torch.cat(deltas[:i])
        checks.append(hold_to_dense(torch, sel, result, results[-1], pool, u, i))
        updates.append(u)
        check_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run - check_s
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sel.ingest, sel.result = ingest, result
    if [u.version for u in updates] != list(SVC_INSTALL_AT):
        raise AssertionError(f"installed versions {[u.version for u in updates]}")
    if launches["fl_replay"] != SVC_DELTAS:
        raise AssertionError(f"fl_replay launched {launches['fl_replay']} times for "
                             f"{SVC_DELTAS} drains")
    log(f"[8] coreset service (budget {SVC_BUDGET}, dim {SVC_DIM}, L={L} sieves): "
        f"{SVC_DELTAS} deltas of {SVC_ROWS} rows ({SVC_DELTAS * SVC_ROWS * SVC_DIM * 4 / 1e6:.0f} "
        f"MB of pool) in {run_s:.1f}s; ingest s per delta: first {ingest_s[0]:.3f}, last "
        f"{ingest_s[-1]:.3f}, median {statistics.median(ingest_s):.3f}; finalize s: first "
        f"{final_s[0]:.3f}, last {final_s[-1]:.3f}; launches {launches}; "
        f"max_memory_allocated {peak_gb:.2f} GB; {card}")
    log(f"[8] installed versions {[u.version for u in updates]}, held to the dense "
        f"finalize: {checks}")

    # fl_replay at the service's last finalize shape
    pool = torch.cat(deltas)
    n = pool.shape[0]
    picks = results[-1].indices[:checks[-1]["replayed"]]
    e = pool[picks].contiguous()
    m = e.shape[0]
    sqx, sqe = torch.sum(pool * pool, dim=1), torch.sum(e * e, dim=1)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    cur0 = torch.zeros(n, device=dev)
    d_max = (2.0 * torch.sqrt(sqx.max()) + 1e-6).reshape(())
    t_ops = n * m * (2 * SVC_DIM + 9) / fp32_peak  # dot, norms, sqrt, gain, cover, best
    t_bytes = (4 * (n * SVC_DIM + m * SVC_DIM + 2 * n + 2 * m) + m + 12 * n + 4 * m) / mem_bw
    rep = {"ms": median_ms(torch, lambda: kfl.fl_replay_cuda(pool, e, sqx, sqe, valid, d_max,
                                                              cur0), 10),
           "plain_ms": median_ms(torch, lambda: kfl.fl_replay_torch(pool, e, sqx, sqe, valid,
                                                                     d_max, cur0), 10),
           **bound(t_ops, t_bytes), "library_ms": None, "launches": launches["fl_replay"],
           "max_abs_err_main": max(c["max_gain_err"] for c in checks)}
    log(f"[8] fl_replay at the last finalize ({n} × {m} × {SVC_DIM}): {rep}")
    del svc, deltas, pool, e, results
    torch.cuda.empty_cache()
    serve_round_trip(card)
    return rep


def hold_to_dense(torch, sel, result, got, pool, u, version) -> dict:
    """Hold the kernel finalize ``got`` (the drain's own result) to the
    dense finalize on the same state.

    A distance d's fp32 rounding is at most τ_d = ``d2_rounding``·(‖x‖² +
    ‖m‖²)/(2·d) (the rounding of ‖x‖² + ‖m‖² − 2·x·m over the derivative
    of the root).
    Indices: equal; or diverging only in the backfill, at a pick whose two
    rows' fp64 residuals lie within τ_d, with fp64 L(S) within 1e-3 after.
    γ: a row can change its medoid only where its two nearest medoids'
    fp64 distances lie within τ_d, so Σ|Δγ| ≤ 2 × such rows.  Gains: each
    one on its own, as ``hold_gains`` holds them."""
    cfg = sel.config
    sel.config = dataclasses.replace(cfg, finalize_impl="dense")
    try:
        want = result(pool)
    finally:
        sel.config = cfg
    if not (torch.equal(got.indices.cpu(), torch.as_tensor(u.indices))
            and torch.equal(got.weights.cpu(), torch.as_tensor(u.weights))):
        raise AssertionError(f"v{version}: the installed update is not the drain's finalize")
    rel = d2_rounding(torch, pool.shape[1])
    st = sel.state()
    replayed = min(int(st.count[int(torch.argmax(st.fval))]), SVC_BUDGET)
    out = {"version": version, "n": pool.shape[0], "replayed": replayed,
           "backfill": SVC_BUDGET - replayed}
    ki, di = got.indices.cpu(), want.indices.cpu()
    med = pool[ki.to(pool.device)].double()
    sqm = float((med * med).sum(dim=1).max())

    def tau_d(xb, dist):
        return rel * ((xb * xb).sum(dim=-1) + sqm) / (2.0 * dist.clamp(min=1e-3))

    diverged = torch.nonzero(ki != di)
    if diverged.numel():
        t = int(diverged[0, 0])
        if t < replayed:
            raise AssertionError(f"v{version}: replayed pick {t} differs")
        rows = pool[torch.stack([ki[t], di[t]]).to(pool.device)].double()
        res = torch.cdist(rows, med[:t]).min(dim=1).values
        if float((res[0] - res[1]).abs()) > float(tau_d(rows, res).max()):
            raise AssertionError(f"v{version}: backfill pick {t} differs ({int(ki[t])} vs "
                                 f"{int(di[t])}) at fp64 residuals {res.tolist()}")
        ca, cb = coverage64(torch, pool, ki.numpy()), coverage64(torch, pool, di.numpy())
        if abs(ca - cb) > 1e-3 * max(ca, cb):
            raise AssertionError(f"v{version}: objectives {ca} and {cb} after a near-tie")
        out.update(indices=f"diverge at backfill pick {t} (near-tie)", max_gain_err=0.0)
        return out
    near = 0
    for lo in range(0, pool.shape[0], 8192):
        xb = pool[lo:lo + 8192].double()
        two = torch.topk(torch.cdist(xb, med), 2, dim=1, largest=False).values
        near += int(((two[:, 1] - two[:, 0]) <= tau_d(xb, two[:, 0])).sum())
    dgamma = float((got.weights - want.weights).abs().sum())
    if dgamma > 2 * near:
        raise AssertionError(f"v{version}: Σ|Δγ| = {dgamma} with {near} near-tie rows")
    gerr = hold_gains(torch, got.gains, want.gains, dist_tol(torch, pool), f"v{version}")
    out.update(indices="equal",
               gamma="equal" if dgamma == 0 else f"Σ|Δγ|={dgamma:.0f} ({near} near-tie rows)",
               max_gain_err=gerr)
    return out


def serve_round_trip(card) -> None:
    """``python -m repro_torch.launch.serve --coreset --device cuda`` over
    real pipes: two deltas, a coreset, a bad request, quit."""
    import numpy as np

    rng = np.random.RandomState(9)
    reqs = [{"op": "delta", "feats": rng.randn(24, 4).tolist()},
            {"op": "delta", "feats": rng.randn(16, 4).tolist()},
            {"op": "coreset"}, {"op": "bogus"}, {"op": "quit"}]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--coreset", "--budget", "6",
         "--dim", "4", "--device", "cuda"],
        input="\n".join(json.dumps(r) for r in reqs) + "\n", capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300,
    )
    if proc.returncode != 0:
        raise AssertionError(f"launch/serve.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    resp = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    sel = resp[2] if len(resp) == 5 else {}
    if (resp[:2] != [{"ok": True, "version": 1, "n_seen": 24},
                     {"ok": True, "version": 2, "n_seen": 40}]
            or not sel.get("ok") or len(set(sel["indices"])) != 6
            or abs(sum(sel["gamma"]) - 40.0) > 1e-6 or resp[3]["ok"] is not False
            or resp[4] != {"ok": True, "bye": True}):
        raise AssertionError(f"launch/serve.py round trip: {resp}")
    log(f"[8] launch/serve.py --coreset --device cuda round trip: 5 requests answered in "
        f"{time.perf_counter() - t0:.1f}s (process start included); coreset v{sel['version']} "
        f"of {sel['n_seen']} rows, Σγ={sum(sel['gamma']):.0f}; {card}")

def main() -> None:
    import torch

    # -- 0. preconditions ---------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; "
                         "run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np

    from repro_torch import parity
    from repro_torch.core import engines as E
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.proxy import convex_feature_proxy
    from repro_torch.data.synthetic import make_classification
    from repro_torch.examples.quickstart import logistic, schedule_for
    from repro_torch.kernels import _build, ce_proxy as kce, fl_gains as kfl, ops
    from repro_torch.optim import ig_run

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    fp32_peak, bf16_peak, mem_bw = peaks_for(name)
    log(f"[0] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 off")
    t_start = time.perf_counter()

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    for src, (lib, text, secs) in _build.build_all().items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[1] built {src}.cu -> {lib.name} in {secs:.2f}s (nvcc); "
            f"ptxas: {' | '.join(regs)}")
    log(f"[1] build phase {time.perf_counter() - t0:.2f}s")

    # -- 2. kernels against their plain versions ----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def operands(n, d):
        x = 3.0 * torch.randn(n, d, device=dev, generator=gen)
        sq = torch.sum(x * x, dim=1)
        d_max = 2.0 * torch.sqrt(sq.max()) + 1e-6
        cur = 0.5 * d_max * torch.rand(n, device=dev, generator=gen)
        chosen = torch.rand(n, device=dev, generator=gen) < 0.3
        if n > 128:
            chosen[:128] = True  # one fully chosen candidate block
        chosen[-1] = False  # at least one live candidate
        return x, sq, d_max, cur, chosen

    max_err = {"fl_gains": 0.0, "fl_gains_argmax": 0.0}
    checked = 0
    for n in CHECK_SIZES:
        for d in CHECK_DIMS:
            x, sq, d_max, cur, chosen = operands(n, d)
            for tile in ("float32", "bfloat16"):
                tol = gain_tol(x, n, float(d_max), tile == "bfloat16")
                before = ops.LAUNCHES["fl_gains_argmax"]
                g, pg, pi = ops.fl_gains_argmax(x, x, cur, sq, sq, d_max, chosen,
                                                tile_dtype=tile, gains_impl="cuda")
                torch.cuda.synchronize()
                if ops.LAUNCHES["fl_gains_argmax"] != before + 1:
                    raise AssertionError("fl_gains_argmax launch counter did not advance")
                gp, pgp, pip = ops.fl_gains_argmax(x, x, cur, sq, sq, d_max, chosen,
                                                   tile_dtype=tile, gains_impl="torch")
                err = float((g - gp).abs().max())
                scale = float(gp.abs().max())
                if err > tol + 1e-5 * scale:
                    raise AssertionError(f"fl_gains_argmax {tile} n={n} d={d}: max "
                                         f"|err| {err} > {tol} + 1e-5·{scale}")
                live = torch.where(chosen, float("-inf"), gp)
                wk, wp = int(pi[torch.argmax(pg)]), int(pip[torch.argmax(pgp)])
                if wk != wp and abs(float(live[wk]) - float(live[wp])) > tol:
                    raise AssertionError(f"fl_gains_argmax {tile} n={n} d={d}: winner "
                                         f"{wk} vs plain {wp} is not a near-tie")
                if bool(chosen[wk]):
                    raise AssertionError("a chosen candidate won the sweep")
                if n > 128 and float(pg[0]) > -1e29:
                    raise AssertionError(f"dead block reported {float(pg[0])}")
                if tile == "float32":
                    max_err["fl_gains_argmax"] = max(max_err["fl_gains_argmax"], err)
                checked += 1
            tol = gain_tol(x, n, float(d_max), False)
            before = ops.LAUNCHES["fl_gains"]
            g = ops.fl_gains(x, x, cur, sq, sq, d_max, gains_impl="cuda")
            torch.cuda.synchronize()
            if ops.LAUNCHES["fl_gains"] != before + 1:
                raise AssertionError("fl_gains launch counter did not advance")
            gp = ops.fl_gains(x, x, cur, sq, sq, d_max, gains_impl="torch")
            err = float((g - gp).abs().max())
            if err > tol + 1e-5 * float(gp.abs().max()):
                raise AssertionError(f"fl_gains n={n} d={d}: max |err| {err} > {tol}")
            max_err["fl_gains"] = max(max_err["fl_gains"], err)
            checked += 1
    log(f"[2] {checked} kernel/plain comparisons passed at (n=m) in {CHECK_SIZES}, "
        f"d in {CHECK_DIMS}; max |gain err| fp32: {max_err}")

    # timing at the main-path sweep shapes: n = m = 33,216 (class 0, the
    # reported shape) and 16,774 (class 1), d = 22, fp32
    sm_clock = max_sm_clock_hz()
    for n in CLASS_SIZES.values():
        d = D_MAIN
        x, sq, d_max, _, _ = operands(n, d)
        cur = torch.zeros(n, device=dev)
        chosen = torch.zeros(n, dtype=torch.bool, device=dev)
        madj = (d_max - cur).contiguous()
        m_blocks = -(-n // _build.library("fl_gains").fl_gains_block_m())
        ops_count = n * n * (2 * d + 8)  # per pair: d FMAs + norms, sqrt, relu, add
        io_bytes = {
            "fl_gains": 4 * (2 * n * d + 3 * n) + 4 * n,
            "fl_gains_argmax": 4 * (2 * n * d + 3 * n) + n + 4 * n + 8 * m_blocks,
        }
        timed = {
            "fl_gains": (
                lambda: kfl.fl_gains_cuda(x, x, madj, sq, sq),
                lambda: kfl.fl_gains_torch(x, x, cur, sq, sq, d_max),
            ),
            "fl_gains_argmax": (
                lambda: kfl.fl_gains_argmax_cuda(x, x, madj, sq, sq, chosen),
                lambda: kfl.fl_gains_argmax_torch(x, x, cur, sq, sq, d_max, chosen),
            ),
        }
        for kname, (kern, plain) in timed.items():
            t_ops, t_bytes = ops_count / fp32_peak, io_bytes[kname] / mem_bw
            r = {
                "ms": median_ms(torch, kern),
                "plain_ms": median_ms(torch, plain),
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "issue_bound_ms": 1e3 * issue_seconds(torch, n, n, d, sm_clock),
            }
            if n == CLASS_SIZES[0]:
                results[kname] = r
            log(f"[2] {kname} at n=m={n}, d={d}: {r}")
    results["ce_proxy"] = check_ce_proxy(torch, ops, kce, dev, gen,
                                         (fp32_peak, bf16_peak, mem_bw))
    max_err.update(check_slice3_kernels(torch, ops, dev, gen))

    # -- 3. select: the main path -------------------------------------------
    x_np, y = make_classification(N_MAIN, D_MAIN, 2, seed=0)
    x_np = x_np / np.abs(x_np).max()
    if {int(c): int(k) for c, k in zip(*np.unique(y, return_counts=True))} != CLASS_SIZES:
        raise AssertionError("make_classification no longer gives the Ijcnn1 class sizes")
    feats = convex_feature_proxy(x_np, device=dev)
    selector = CraigSelector(CraigConfig(fraction=0.1, per_class=True), device=dev)
    torch.cuda.synchronize()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    cs = selector.select(feats, y)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    main_launches = dict(ops.LAUNCHES)
    if cs.engine["name"] != "device":
        raise AssertionError(f"engine='auto' picked {cs.engine}, expected device")
    if main_launches["fl_gains_argmax"] != sum(BUDGETS.values()):
        raise AssertionError(f"fl_gains_argmax launched {main_launches}, expected "
                             f"{sum(BUDGETS.values())} (one per greedy round)")
    if cs.per_class_sizes != BUDGETS:
        raise AssertionError(f"per-class budgets {cs.per_class_sizes} != {BUDGETS}")
    if float(cs.weights.sum()) != N_MAIN or len(np.unique(cs.indices)) != cs.size:
        raise AssertionError("Σγ != n or duplicate indices")
    if not math.isfinite(cs.coverage):
        raise AssertionError(f"coverage {cs.coverage}")
    log(f"[3] main path: selected {cs.size}/{N_MAIN} with engine {cs.engine} in "
        f"{select_s:.3f}s; launches {main_launches}; Σγ={cs.weights.sum():.0f}; "
        f"L(S)={cs.coverage:.4f}")

    # the same selection with the plain sweep on the card
    t0 = time.perf_counter()
    plain = CraigSelector(CraigConfig(fraction=0.1, per_class=True,
                                      engine=E.DeviceConfig(gains_impl="torch")),
                          device=dev).select(feats, y)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diverged = compare_selections(torch, parity, "main path", cs, plain, feats, y)
    log(f"[3] main path, plain sweep: {plain_s:.3f}s, L(S)={plain.coverage:.4f}; "
        f"kernel against plain: {verdict(diverged)}")

    # reduced pool, kernel against plain sweep, through both engines
    xr_np, yr = make_classification(N_REDUCED, D_MAIN, 2, seed=0)
    xr_np = xr_np / np.abs(xr_np).max()
    xr = convex_feature_proxy(xr_np, device=dev)
    for label, cfg_cuda, cfg_torch in (
        ("device", E.DeviceConfig(gains_impl="cuda"), E.DeviceConfig(gains_impl="torch")),
        ("features", E.FeaturesConfig(gains_impl="cuda"), E.FeaturesConfig(gains_impl="torch")),
    ):
        torch.cuda.synchronize()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        a = CraigSelector(CraigConfig(fraction=0.1, engine=cfg_cuda), device=dev).select(xr, yr)
        torch.cuda.synchronize()
        ta = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        if label == "features":
            results["fl_gains"]["launches"] = launches["fl_gains"]
        t0 = time.perf_counter()
        b = CraigSelector(CraigConfig(fraction=0.1, engine=cfg_torch), device=dev).select(xr, yr)
        torch.cuda.synchronize()
        tb = time.perf_counter() - t0
        kern = "fl_gains" if label == "features" else "fl_gains_argmax"
        if launches[kern] != a.size:
            raise AssertionError(f"{label}: {launches} launches for {a.size} rounds")
        diverged = compare_selections(torch, parity, label, a, b, xr, yr)
        log(f"[3] reduced pool {N_REDUCED} ({label}): kernel {ta:.3f}s "
            f"({launches[kern]} {kern} launches), plain {tb:.3f}s; {verdict(diverged)}")

    # q > 1: the lazy path's host syncs at the main-path class-0 pool
    pool0 = torch.as_tensor(np.nonzero(y == 0)[0], device=dev)
    x0 = feats[pool0]
    for q, tol in ((1, 0.7), (16, 0.7)):
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = E.greedy_fl_device(x0, BUDGETS[0], q=q, stale_tol=tol, stats=stats)
        torch.cuda.synchronize()
        log(f"[3] device engine q={q} stale_tol={tol} on class 0 ({CLASS_SIZES[0]} × "
            f"{D_MAIN}, r={BUDGETS[0]}): {time.perf_counter() - t0:.3f}s, {stats} "
            f"(host syncs = lazy rounds), "
            f"L(S)={float(r.coverage):.4f}, Σγ={float(r.weights.sum()):.0f}")

    # -- 4. train -----------------------------------------------------------
    grad_one, full_loss = logistic(feats, y, LAM)
    sched = schedule_for(N_MAIN)
    loss0 = full_loss(torch.zeros(D_MAIN, device=dev))
    arms = {
        "craig": (cs.indices, cs.weights),
        "random": (np.random.RandomState(0).choice(N_MAIN, cs.size, replace=False),
                   np.full(cs.size, N_MAIN / cs.size, np.float32)),
        "full": (np.arange(N_MAIN), np.ones(N_MAIN, np.float32)),
    }
    for arm, (idx, w) in arms.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w_end, _ = ig_run(grad_one, torch.zeros(D_MAIN, device=dev), idx, w, sched,
                          TRAIN_EPOCHS)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / TRAIN_EPOCHS
        loss = full_loss(w_end)
        if not (math.isfinite(loss) and loss < loss0):
            raise AssertionError(f"{arm}: loss {loss} is not below {loss0}")
        log(f"[4] train {arm}: {len(idx)} steps/epoch, {secs:.3f}s/epoch, loss "
            f"{loss:.6f} after {TRAIN_EPOCHS} epochs (w0: {loss0:.6f} = log 2)")

    # -- 5. LM proxies at full width --------------------------------------
    full_width_proxy_check(torch, ops, card, dev)

    # -- 6. LM coreset training: the slice-2 main path ----------------------
    sync = train_lm(torch, ops, card, dev, "sync", LM_STEPS, (3, 2), "main path")
    results["ce_proxy"]["launches"] = sync["launches"]
    # the trainer's default mode: the first selection overlaps epoch 0
    asyn = train_lm(torch, ops, card, dev, "async", LM_ASYNC_STEPS, (2, 1), "async")
    # Both modes train on the full data until the first install, from the
    # same seed: bf16 steps through cuBLAS and the embedding's scattered
    # backward need not repeat bit for bit, so a relative 1e-2.
    n0 = LM_DOCS // LM_BATCH
    drift = max(abs(a - b) / abs(b) for a, b in zip(asyn["losses"][:n0], sync["losses"][:n0]))
    if drift > 1e-2:
        raise AssertionError(f"async and sync epoch-0 losses differ by {drift:.3e} (rel)")
    log(f"[6] async against sync, epoch 0: largest relative loss difference {drift:.3e}")
    max_err["ce_proxy"] = results["ce_proxy"]["max_abs_err"]

    # -- 7. Covtype-shaped selection: the slice-3 sparse path ---------------
    peaks = (fp32_peak, bf16_peak, mem_bw)
    results.update(covtype_selection(torch, ops, card, dev, peaks))
    for kname in ("topk_sim", "pairwise_l2"):
        max_err[kname] = max(max_err[kname], results[kname].pop("max_abs_err_main", 0.0))

    # -- 8. the streaming coreset service: the slice-3 serving path --------
    results["fl_replay"] = coreset_service(torch, ops, card, dev, peaks)
    max_err["fl_replay"] = max(max_err["fl_replay"], results["fl_replay"].pop("max_abs_err_main"))

    # -- 9. report ----------------------------------------------------------
    replaces = {
        "fl_gains": "src/repro/kernels/fl_gains.py:106",
        "fl_gains_argmax": "src/repro/kernels/fl_gains.py:197",
        "ce_proxy": "src/repro/kernels/ce_proxy.py:113",
        "topk_sim": "src/repro/kernels/topk_sim.py:115",
        "pairwise_l2": "src/repro/kernels/pairwise_l2.py:38",
        "fl_replay": "src/repro/kernels/fl_gains.py:338",
    }
    sources = {"fl_gains": "src/repro_torch/kernels/csrc/fl_gains.cu",
               "fl_gains_argmax": "src/repro_torch/kernels/csrc/fl_gains.cu",
               "ce_proxy": "src/repro_torch/kernels/csrc/ce_proxy.cu",
               "topk_sim": "src/repro_torch/kernels/csrc/topk_sim.cu",
               "pairwise_l2": "src/repro_torch/kernels/csrc/pairwise_l2.cu",
               "fl_replay": "src/repro_torch/kernels/csrc/fl_replay.cu"}
    results["fl_gains_argmax"]["launches"] = main_launches["fl_gains_argmax"]
    kernels = []
    for kname in replaces:
        r = results[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": sources[kname],
            "replaces": replaces[kname], "launches": r["launches"],
            "max_abs_err": max_err[kname], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
        })
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel of the path was never launched: {kernels}")
    log(f"[9] ce_proxy fp32 at the main-path shape: {results['ce_proxy']['fp32']}")
    log(f"[9] total {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
