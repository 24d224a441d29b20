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
     its plain version at T = 4,096, D = 2048, V = 151,936, at the (D,
     padded V) of the nine configs of phase 9 (D 1,536 to 6,144) and at
     ragged shapes up to D = 8,200, then timed the same way, the nine
     configs' shapes and the SIMT route's beside the einsum head
     (``core.proxy.lm_unembed_input_proxy``) with each bf16 route's cluster
     size and clusters in flight;
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
     timed at the path's shapes (beside ``pairwise_l2`` ``torch.cdist``,
     its issue bound, registers and CTAs per SM; beside ``topk_sim`` the
     same figures, the cuBLAS product of its shape, and its time at
     k = 256); a
     ``SparseConfig(k=256)`` selection on the card held to the CPU's;
  8. the streaming coreset service, slice 3's second path:
     ``CoresetService(budget=1024, dim=2048)`` fed 16 seeded deltas of
     4,096 rows, every finalize through ``fl_replay``, the four installed
     selections held to the dense finalize; ``fl_replay`` timed at the
     service's shape (with its issue bound, registers, CTAs per SM and
     the cuBLAS product of its shape); a ``launch/serve.py --coreset
     --device cuda`` round trip in a subprocess;
  9. LM coreset training at the published widths, slice 7's path: six
     more registered configs — qwen2-7b, granite-3-8b, nemotron-4-15b, the
     MoE configs moonshot-v1-16b-a3b and dbrx-132b, and (slice 10) the
     Griffin hybrid recurrentgemma-9b — at full width with depth cut to fit
     the card (WIDE_LM), seeded on the card; per config
     the fused proxies held to the einsum proxies and both heads timed,
     then ``Trainer.run`` through two refreshes and one install (dbrx-132b:
     one refresh through ``ProxyExtractor`` and ``CraigSelector``, forward
     only), every refresh launching ``ce_proxy`` at the config's (D,
     padded V); (slice 11) xlstm-1.3b (one mLSTM/sLSTM period) through
     ``Trainer.run`` the same way, and the stub-frontend configs
     qwen2-vl-7b (M-RoPE over image-grid positions) and musicgen-medium
     (four codebook heads: four ``ce_proxy`` launches a batch) through
     ``make_train_step``, ``make_select_step`` and ``CraigSelector`` on
     seeded batches in the reference's ``train_batch_struct`` layout; one
     qwen3-1.7b training step under each remat policy ('nothing', 'dots',
     'full'), losses equal and gradients held to 'nothing''s; then a
     ``launch/train.py --smoke --device cuda`` subprocess;
 10. slice 8's paths: the ``stochastic`` engine on phase 3's pool through
     ``CraigSelector`` (F within 1 − 1/e − δ of phase 3's selection per
     class; class 1 again on the CPU, the same candidates, held under the
     tie rule), the ``lazy`` engine on phase 3's reduced pool held to the
     ``matrix`` engine, and ``Trainer.run`` with ``streaming_ingest`` at
     qwen3-1.7b width on a corpus growing from 128 to 512 docs under a
     fault plan that fails one refresh attempt: each drain extracts only
     the new docs (``ce_proxy``) and finalizes through ``fl_replay``, the
     last install held to the dense finalize;
 11. slice 9's distributed path on the whole Covtype-shaped pool: (a)
     ``CraigSelector.select_distributed`` over a 4-shard mesh of the one
     card (sparse leaves: one ``topk_sim`` a shard) held bit for bit to
     ``select_tree((4,), compress='none')``; (b) a (8, 4) tree of 32
     ``device`` leaves (``fl_gains_argmax``) on the int8 and the fp32 wire,
     F(int8)/F(fp32) ≥ 0.95 over the whole pool; (c) four
     ``launch/tree.py --device cuda`` processes over a ``TCPStore``, held
     bit for bit to ``tree_select_host``, and a chaos run whose killed leaf
     degrades the survivors under quorum; (d) ``ProxyExtractor(mesh=...)``
     at qwen3-1.7b width (``ce_proxy``) held bit for bit to the
     single-device extract;
 12. slice 10's serving path (``serve.make_prefill_step``,
     ``models.decode_step``, ``serve.greedy_generate``): (a) qwen3-1.7b
     and (b) recurrentgemma-9b at full published depth and width — prefill
     timed, a teacher-forced decode held to ``forward`` (and prefill's last
     logits to the decode path's), greedy generation run twice and equal;
     (c) one recurrentgemma-9b period teacher-forced past its 2,048-slot
     ring, and ``forward`` past 2·window through the blockwise windowed
     path, one layer's blockwise attention held to the dense one; (d)
     moonshot-v1-16b-a3b at published width, 8 of 48 layers (the MoE FFN
     in decode); (e) ``launch/serve.py --arch qwen3-1.7b --smoke`` and
     ``examples/serve_batched.py --window 8`` subprocesses on the card;
     slice 11 at full published depth and width: (f) xlstm-1.3b (prefill,
     teacher-forced decode held to ``forward``, in bf16 and with fp32
     products, greedy generation twice),
     (g) qwen2-vl-7b over seeded embeddings (prefill over an image grid's
     M-RoPE positions; M-RoPE with equal streams held to RoPE; decode held
     to ``forward``) and (h) musicgen-medium (every codebook's logits held
     to ``forward``, also with fp32 products).  No kernel runs on this
     path (the reference's is plain JAX too);
 13. slice 12's dry run and roofline (``launch/dryrun.py``,
     ``roofline.py``): (a) the p1 and p2 probes of every arch × shape cell
     and the full-depth decode_32k, long_500k and select_pool cells,
     traced on fake tensors of the card's device type by three
     ``launch/dryrun.py`` subprocesses started before phase 12, each
     cell's reckoned GB, ``fits``, dominant term and bound printed; (b) the
     cells one card holds run for real on phase 12's models, each measured
     peak (``max_memory_allocated``) held to the in-process reckoning of
     the same cell within PEAK_TOL and its ms printed against its roofline
     bound: long_500k decode steps from position 524,284 and decode_32k at
     batch 128 for recurrentgemma-9b and xlstm-1.3b, decode_32k for
     qwen3-1.7b at the largest batch the reckoning fits, and the
     qwen3-1.7b select step at 8 × 4,096 (``ce_proxy`` at (32,768, 2,048,
     151,936), held to its plain twin there);
 14. slice 13's model parallelism (``distributed/sharding.py``,
     ``annotate.py``, ``collectives.py``; the steps on DTensors): (a) the
     reference's production meshes, every arch's train_4k, decode_32k and
     select_pool probes on 16×16 and qwen3-1.7b's and dbrx-132b's
     train_4k probes on 2×16×16, traced per device under a fake 256- or
     512-rank group by two ``launch/dryrun.py --mesh`` subprocesses
     started before phase 11; per cell the per-device argument and peak
     bytes, collective bytes by kind and the roofline's three terms, each
     train cell's parameter and optimizer bytes held to the reference's
     placement (12 bytes an element) and each 16×16 train cell's
     collective term to be non-zero; (b) a real (1, 1) ("data", "model")
     mesh over NCCL in a group of one at qwen3-1.7b's full width and
     depth: the AdamW train step, the select step (its ``ce_proxy``
     launch on the device's tokens through the op's sharding rule,
     counted, the kernel held to its plain twin) and decode steps on a
     ``serve_state_specs`` cache, each held bit for bit to the step
     without a mesh, s a step and peak bytes beside it.  No multi-card
     run: NCCL puts no two ranks on one card;
 15. slice 14's static analysis (``repro_torch.analysis``): (a) the
     port's repro-lint over ``src/repro_torch`` in-process, no active
     finding, its counts by rule and suppressed sites printed; (b) the
     ``LAUNCHES`` keys the CUDA contract pass finds the launching wrappers
     bump, equal to ``_build.LAUNCHES`` and to the report's kernels; (c)
     the host-sync pass held to the card: ``features`` and ``device`` at
     q = 1 on a seeded 4,096 × 22 pool at budgets 32 and 64 under
     ``torch.cuda.set_sync_debug_mode("warn")``, the synchronizing calls
     counted and required equal across budgets (``device`` at q = 16,
     the documented exception, printed without a gate); ≤ 30 s;
 16. slice 15's tree selection over a ``torch.distributed`` group, one
     program a rank (``launch/tree.py::make_tree_mesh``,
     ``tree_select_mesh`` over its ``DeviceMesh``): (a) in process, NCCL in
     a group of one, fan-outs (8, 4, 1) on phase 7's pool cut to
     MESH_TREE_N rows: 32 ``device`` leaves (``fl_gains_argmax``) and the
     two lower levels on ``cuda:0``, the fan-out-1 root level and the
     re-weighting's gathers through NCCL, the int8 wire, held bit for bit
     to ``tree_select_host`` on the same rows and topology, the collectives
     counted against ``collectives_plan``; (c) in the same group, slice
     16's proxy extraction over a ``DeviceMesh`` of ranks:
     ``ProxyExtractor(mesh=init_device_mesh("cuda", (1,), ("data",)))``
     on phase 11 (d)'s cell (qwen3-1.7b at full width and depth, DP_DOCS
     docs in LM_BATCH × LM_SEQ batches, one ``ce_proxy`` launch a batch,
     one ``all_gather_into_tensor`` a dispatch) held bit for bit to the
     single-device extract, then its features through
     ``CraigSelector.select_distributed`` over the same mesh, held bit for
     bit to the same call over a one-shard ``compat_mesh`` of the card, Σγ
     = DP_DOCS; s and peak bytes printed beside 11 (d)'s; (b)
     ``launch/tree.py --driver mesh --device cuda``: one process (fan-outs
     2,2,1) held bit for bit to ``tree_select_host``, and two processes,
     which must fail with the one-rank-per-card error on a one-card host
     (with two or more cards they run and are held the same way);
 17. the report: one JSON line per the eight kernels, then the last line,
     {"ok": true, "device": {...}}.

Before phases 2–8, ``kernels`` compares ``topk_sim`` (both list routes:
k ≤ 128 and k > 128 up to k = n), ``pairwise_l2`` and ``fl_replay`` with
their plain versions at ragged shapes, and AdamW's ``adamw_sq_norm`` and
``adamw_update`` with the plain loop (``check_adamw``: ragged leaves, a
slice of qwen2-7b's leaves and a (1, 1) DTensor mesh, 5 steps each; both
passes timed at the benchmark's qwen2-7b and granite-3-8b leaf sets
beside their byte bounds, the loop and the library's multi-tensor calls).
Every ``Trainer.run`` of phases 6, 9 and 10 launches ``adamw_sq_norm`` and
``adamw_update`` once a step (the clip is set), and the report counts those
launches.

Any failure raises and exits non-zero.  Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import atexit
import concurrent.futures
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
# The horizon of phase 10's learning-rate schedule.
LM_STEPS = 84
# Phase 6's corpus (cut from LM_DOCS to hold the script near 11 minutes
# once phase 12 came, PERF.md §4): 32 full-data steps (epoch 0; selection
# v1 at step 0), 9 steps on the first coreset of 77 docs (epoch 1; v1
# installed, v2 selected at step 32), and the first step of epoch 2 (v2
# installed, v3 selected): three refreshes.  The asynchronous run: epoch 0
# while v1 is selected in the background, then the install of v1 (and v2
# started) at step 32.
MAIN_DOCS, MAIN_STEPS, MAIN_ASYNC_STEPS = 256, 42, 33
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
    # the configurations of phase 9 at their published (D, padded V), T =
    # 4,096 (an 8 × 512 batch): route 2 (512 columns a CTA) in 7- and
    # 8-CTA clusters, and in non-portable 12-CTA clusters; granite-3-8b
    # unpadded and padded (a ragged last valid vocab block); moonshot's V =
    # 163,840 on route 1
    (4096, 3584, 152_064, 152_064),
    (4096, 4096, 49_155, 49_155),
    (4096, 4096, 49_280, 49_155),
    (4096, 6144, 256_000, 256_000),
    (4096, 2048, 163_840, 163_840),
    (4096, 6144, 100_352, 100_352),
    (4096, 4096, 256_000, 256_000),  # recurrentgemma-9b (8-CTA clusters)
    # slice 11: xlstm-1.3b on route 1 (8-CTA clusters), V = 50,304 not a
    # multiple of the 256-row TMA box pair: a ragged last vocab block;
    # musicgen-medium's codebook head on route 1 in 6-CTA clusters
    (4096, 2048, 50_304, 50_304),
    (4096, 1536, 2048, 2048),
    # ragged wide shapes: route 2 just past 2,048 and just past 4,096
    # columns (a non-portable 9-CTA cluster); route 2 with D % 8 != 0 (the
    # staged route); the SIMT route past 8,192
    (129, 2056, 4099, 4097),
    (37, 4104, 3001, 2999),
    (5, 6150, 1000, 997),
    (64, 8200, 4099, 4097),
)
# Phase 9's configs: (D, padded V, valid V) of ``ce_proxy`` on their path,
# each timed beside the einsum head in phase 2.
CE_WIDE = {"qwen2-7b": (3584, 152_064, 152_064), "granite-3-8b": (4096, 49_280, 49_155),
           "nemotron-4-15b": (6144, 256_000, 256_000),
           "moonshot-v1-16b-a3b": (2048, 163_840, 163_840),
           "dbrx-132b": (6144, 100_352, 100_352),
           "recurrentgemma-9b": (4096, 256_000, 256_000),
           "xlstm-1.3b": (2048, 50_304, 50_304), "qwen2-vl-7b": (3584, 152_064, 152_064),
           "musicgen-medium": (1536, 2048, 2048)}
CE_TIMED = {"bfloat16": 5, "float32": 3}  # CUDA-event-timed launches
PROXY_TIMED = 5  # CUDA-event-timed calls of each proxy path at full width
# Device memory still allocated after a trainer is deleted; its parameters
# alone are 8.1 GB.
FREED_GB = 4.0
# Phase 9: depth of each config (layers kept of the published count) and
# whether it trains.  16 bytes a parameter (fp32 weights, gradients, both
# AdamW moments) plus ~6 GB of activations fit one 80 GB card: qwen2-7b 8
# of 28 layers (2.95 B parameters), granite-3-8b 8 of 40 (2.00 B),
# nemotron-4-15b 2 of 32 (3.93 B, its 3.1 B of vocabulary tables
# dominate), moonshot-v1-16b-a3b 4 of 48 (3.02 B, C = 64), recurrentgemma-9b
# one (rglru, rglru, local_attn) period, 3 of 38 layers (2.75 B).  dbrx-132b
# keeps 2 of 40 layers (7.75 B, 31.0 GB in fp32) and runs forward only: one
# of its layers with AdamW alone needs 71.9 GB.
WIDE_LM = {"qwen2-7b": (8, True), "granite-3-8b": (8, True), "nemotron-4-15b": (2, True),
           "moonshot-v1-16b-a3b": (4, True), "dbrx-132b": (2, False),
           "recurrentgemma-9b": (3, True), "xlstm-1.3b": (8, True)}
# Slice 11's configs with a stub modality frontend, trained through
# ``make_train_step`` and ``make_select_step`` on seeded batches in the
# reference's ``train_batch_struct`` layout (the ``Trainer`` reads a token
# stream): (layers kept or None for all, full-data steps).  qwen2-vl-7b
# keeps 8 of 28 layers (2.41 B, 38.6 GB at 16 bytes a parameter, as
# qwen2-7b); musicgen-medium trains whole (1.37 B, 21.9 GB).  xlstm-1.3b
# (WIDE_LM) keeps one (7 × mlstm, slstm) period, 8 of 48 layers (0.41 B):
# a cut for time, not memory, since its sLSTM runs a 512-step loop a layer.
WIDE_EMB = {"qwen2-vl-7b": (8, 8), "musicgen-medium": (None, 8)}
# The image grid (rows, columns) among a training sequence's LM_SEQ
# positions: 64 text tokens, 16 × 24 patches, 64 text tokens.
TRAIN_GRID = (64, 16, 24)
# A pool of 64 docs, 8 batches of 8 × 512 tokens a refresh: epoch 0 is 8
# full-data steps (v1 selected at step 0); step 9 installs v1 and selects
# v2.  Two refreshes, one install.
WIDE_DOCS, WIDE_STEPS = 64, 9
# AdamW peak learning rate of phase 9, reached after 2 steps: of the rates
# ``chip_variants.py --lr-probe`` tries on these seeded models, the one
# whose least fall of the step loss over the configs is widest; at 1e-4
# and 3e-4 the losses swing by nats from batch to batch and some runs end
# above their first loss.
WIDE_LR = 3e-5

# Slice 3, path 1: the Covtype-shaped pool (paper §5.1's Covtype is
# 581,012 × 54 in seven classes; the real file is not in the repository).
COV_N, COV_D, COV_CLASSES = 581_012, 54, 7
COV_SIZES = {0: 223_780, 1: 112_297, 2: 74_513, 3: 56_464, 4: 44_663, 5: 37_146, 6: 32_149}
COV_BUDGETS = {0: 22_378, 1: 11_230, 2: 7_451, 3: 5_646, 4: 4_466, 5: 3_715, 6: 3_215}
COV_K = 64  # SparseConfig().k
# (n, d, k): k <= 128 keeps the lists in registers (d > 64 walks in chunks:
# 130, 257), k > 128 in the outputs' rows, up to k = n
TOPK_CHECKS = ((1, 1, 1), (37, 5, 7), (130, 12, 23), (300, 33, 64), (1000, 54, 64),
               (4099, 3, 33), (2000, 130, 100), (5000, 54, 128), (1500, 257, 128),
               (2000, 54, 129), (2000, 54, 256), (4099, 22, 1024), (300, 12, 300),
               (700, 100, 200))
# (n, m, d) of pairwise_l2: each loading route of the kernel: bulk copies
# (d = 2 mod 4 up to 58), staged loads (d = 0 mod 4, odd d, ragged tiles)
# and the chunked route past 58 dims (ragged chunks at d = 130 and 2,050)
PAIR_CHECKS = ((1, 1, 1), (37, 5, 3), (130, 129, 22), (999, 1001, 7), (1000, 777, 54),
               (500, 700, 32), (100, 300, 57), (77, 1000, 58), (5, 1000, 59),
               (300, 1000, 130), (257, 513, 2050))
# (n, m, d): d = 2,050 is not a multiple of 4 (no bulk copies) and ends in a
# ragged 32-dim chunk; m = 1,000 ends in a ragged candidate tile
REPLAY_CHECKS = ((1, 1, 1), (37, 5, 3), (130, 129, 22), (1000, 300, 54), (3000, 1024, 2048),
                 (1000, 300, 2050), (3001, 1000, 2048))
# AdamW's kernels (adamw.cu): ragged leaves (one more, offset by a float, is
# not 16-byte aligned; one is empty), steps of each held comparison, the
# benchmark's cut depths timed at full width, and the comparison's bound on
# max|kernel − twin| / max|twin| of p, m and v a leaf: a few fp32 ulps (the
# norm's summation order; contractions inside PyTorch's elementwise kernels).
ADAMW_RAGGED = (1, 3, 4, 5, 4097, 65_535, 65_536, 65_537, 300_001, 0)
ADAMW_STEPS = 5
ADAMW_CUTS = {"qwen2-7b": 8, "granite-3-8b": 12}
ADAMW_TOL = 1e-5
ADAMW_KERNELS = ("adamw_sq_norm", "adamw_update")
ADAMW_RISE_MB = 64  # allocator high-water mark an update may add
# Slice 3, path 2: the streaming coreset service at the width of the
# qwen3-1.7b proxies (ce_proxy's D); eps = 0.15 gives 56 sieves.
SVC_BUDGET, SVC_DIM, SVC_DELTAS, SVC_ROWS, SVC_CLUSTERS = 1024, 2048, 16, 4096, 64
SVC_INSTALL_AT = (4, 8, 12, 16)

# Phase 10, the streaming-ingest trainer at qwen3-1.7b width: the corpus
# (LM_DOCS docs) is visible from STREAM_FIRST docs and grows by STREAM_GROW
# after each install; the run ends at the STREAM_DRAINS-th install
# (budget round(LM_FRACTION × STREAM_FIRST) = 38, 4 coreset steps an
# epoch: 41 steps), or fails past STREAM_MAX_STEPS.
STREAM_FIRST, STREAM_GROW, STREAM_DRAINS, STREAM_MAX_STEPS = 128, 128, 4, 60

# Phase 11, distributed selection over the whole Covtype-shaped pool (the
# two-round and tree paths are global, not per class): (a) the two rounds
# on a TREE_SHARDS-shard mesh of the one card and the one-level fp32 tree,
# sparse leaves; (b) a TREE_FANOUTS tree with device leaves on both wires;
# (c) the process driver, PROC_* per launch/tree.py; (d) the data-parallel
# extract of DP_DOCS docs (16 batches of LM_BATCH × LM_SEQ) at qwen3-1.7b
# width.  F and L of (b) are taken over F_BLOCK-row blocks.  (b) at
# fraction 0.005 took 29.7 s of a 95.8 s phase on the H100; 0.0025 halves
# its rounds.  MERGE_STEPS of (a)'s merge picks are held to an fp64
# greedy.  OBJ_GATE is bench_tree_select.py's; F is mostly n·d_max, so
# L_GATE holds L(S) of the pool itself: the int8 wire may cost 1% of it.
# Three runs on the H100 put the two wires' L(S) within 2e-5 of each other
# (from the F they printed).
TREE_SHARDS, TREE_FRACTION, MERGE_STEPS = 4, 0.01, 128
TREE_FANOUTS, TREE_DEEP_FRACTION, OBJ_GATE, L_GATE = (8, 4), 0.0025, 0.95, 1.01
PROC_N, PROC_D, PROC_R_LOCAL, PROC_R_FINAL = 65_536, 64, 256, 512
PROC_TIMEOUT = 300
DP_DOCS = 128
F_BLOCK = 8192

# Phase 12, serving.  Per cell: (arch, layers kept or None for the
# published depth, prefill (batch, tokens), teacher-forced decode (batch,
# tokens) held to forward, greedy_generate (batch, prompt, new), runs of
# it that must agree, the forward-against-decode bound).  qwen3-1.7b
# (8.1 GB fp32) and recurrentgemma-9b (41.8 GB) serve at full depth;
# moonshot-v1-16b-a3b (115.6 GB in fp32) keeps 8 of 48 layers.  Bounds,
# max|Δ|/max|ref|: the reference's (tests/test_models_consistency.py), 2e-2
# and 4e-2 for the recurrent families, whose scans reassociate, at its
# depth of 2 and 5 layers.  Over recurrentgemma-9b's 38 bf16 layers the
# seeded model's error grows like a random walk (1.7e-2, 2.3e-2, 3.2e-2,
# 5.2e-2, 6.5e-2 at 3, 6, 12, 24, 38 layers on the H100, PERF.md): its
# full-depth run is held to 4e-2·√(38/5) = 0.110.  qwen3-1.7b's 28 layers
# stay within 2e-2 (1.8e-2).
SERVE_CELLS = {
    "(a)": ("qwen3-1.7b", None, (8, 512), (2, 64), (8, 64, 128), 2, 2e-2),
    "(b)": ("recurrentgemma-9b", None, (2, 4096), (2, 64), (4, 64, 64), 2,
            4e-2 * math.sqrt(38 / 5)),
    "(d)": ("moonshot-v1-16b-a3b", 8, (8, 512), (2, 32), (4, 32, 32), 1, 2e-2),
}
# (c): one recurrentgemma-9b period teacher-forced past its 2,048-slot ring,
# the last RING_KEEP steps held to forward within RING_TOL (the reference's
# recurrent-family bound); forward at BLOCK_T > 2·window.
RING_T, RING_KEEP, BLOCK_T, RING_TOL = 2112, 64, 5120, 4e-2
# Slice 11's serving cells, as SERVE_CELLS; prefill and decode over seeded
# embeddings where the frontend is a stub (no greedy run: the reference's
# generator feeds back tokens).  xlstm-1.3b (5.7 GB), qwen2-vl-7b (28.3
# GB) and musicgen-medium (5.5 GB) serve whole.  vlm: the reference's
# 2e-2, as qwen3-1.7b's 28 layers.  xlstm and musicgen: the reference's
# gates (tests/test_models_consistency.py: 4e-2 at 4 xlstm layers, 2e-2 at
# 2 musicgen layers, 24 steps) do not hold at 48 layers, not even for the
# reference: at smoke width its own xLSTM decode is 6.7e-2 off its forward
# at 48 layers, and its musicgen decode 2.3e-2 off the port's
# (tests/test_torch_decode.py::test_decode_at_depth_is_the_references).
# So each bound is SERVE_MARGIN × the larger of the cell's two readings
# on an H100 (chip_variants.py --serve-probe, seeded as here, so the same
# every run): decode against forward and prefill's last logits against
# decode's, xlstm 0.1858 and 0.2099 (3.35e-2 over the reference's 4
# layers and 24 steps: its states integrate their bf16 inputs' rounding
# along the sequence, 2.1e-2 at step 0, 0.210 at step 63), musicgen
# 2.099e-2 and 1.766e-2 (4.0e-3 at 2 layers).  With every product in fp32
# (FP32_DECODE_TOL) the same margin over 2.101e-5 (xlstm) and 2.617e-3
# (musicgen: the bf16 KV cache's rounding).
SERVE_MARGIN = 1.25
SERVE_EMB_CELLS = {
    "(f)": ("xlstm-1.3b", None, (2, 1024), (2, 64), (4, 64, 64), 2, SERVE_MARGIN * 0.2099),
    "(g)": ("qwen2-vl-7b", None, (2, 4096), (2, 64), None, 0, 2e-2),
    "(h)": ("musicgen-medium", None, (2, 4096), (2, 64), None, 0, SERVE_MARGIN * 2.099e-2),
}
FP32_DECODE_TOL = {"(f)": SERVE_MARGIN * 2.101e-5, "(h)": SERVE_MARGIN * 2.617e-3}
# (g)'s prompt, after arXiv:2409.12191: 1,024 text positions, a 32 × 64
# patch grid (t fixed, h and w over the grid), then text that resumes
# after the grid's largest position.
SERVE_GRID = (1024, 32, 64)
# Remat on the card: one qwen3-1.7b training step of 8 × 512 tokens under
# each policy, the same seed and batch.  Gradients are held per tensor to
# REMAT_TOL·max|g|: the recompute repeats each bf16 op, but the embedding's
# scattered backward adds in fp32 in no fixed order.
REMAT_POLICIES, REMAT_TOL = ("nothing", "dots", "full"), 1e-4

# Phase 13: the dry-run sweep's three subprocesses (archs dealt round
# robin) write here; each real cell's measured peak must lie within
# PEAK_TOL (relative) of its reckoned peak, a tolerance written down before
# the first card run (PERF.md §6, PR 22); decode cells take DECODE_STEPS
# timed steps, long_500k's from LONG_FROM; the qwen3-1.7b decode_32k batch
# is the largest of DECODE_BATCHES the reckoning fits in DECODE_FILL of
# the card's free memory; SELECT_BT cuts select_pool's 256 × 4,096 batch.
DRYRUN_DIR = ROOT / "artifacts" / "dryrun_torch"
DRYRUN_WORKERS = 3
PEAK_TOL = 0.10
DECODE_STEPS = 3
LONG_FROM = 524_284
DECODE_BATCHES = (128, 64, 32, 16, 8)
DECODE_FILL = 0.9
SELECT_BT = (8, 4096)
# Phase 14 (a): the reference's production meshes, traced per device in
# MESH_WORKERS ``launch/dryrun.py --mesh`` processes started before phase
# 11 (host work alone, beside phases 11–13): every arch's train_4k,
# decode_32k and select_pool probes on 16×16, qwen3-1.7b's and dbrx-132b's
# train_4k probes on 2×16×16.  MESH_PARAMS: per-device parameter elements
# of the reference's param_specs over its tree on 16×16 (and 2×16×16: pod
# replicates), at 12 bytes an element (fp32 weight, AdamW m and v) the
# train cells' parameter and optimizer bytes, held within STATE_TOL.
MESH_WORKERS = 2
MESH_CELLS = {"single": ("train_4k", "decode_32k", "select_pool"), "multi": ("train_4k",)}
MESH_MULTI_ARCHS = ("qwen3-1.7b", "dbrx-132b")
MESH_PARAMS = {"qwen3-1.7b": 14.9e6, "qwen2-7b": 78.2e6, "nemotron-4-15b": 85.0e6,
               "moonshot-v1-16b-a3b": 113.4e6, "dbrx-132b": 544.3e6,
               "recurrentgemma-9b": 93.8e6}
STATE_TOL = 0.01
# Phase 14 (b): a real world-1 mesh over NCCL, (1, 1) ("data", "model"),
# qwen3-1.7b at full width and depth on batches of MESH_BT; decode over
# MESH_DECODE_STEPS tokens of a MESH_BT[1]-slot cache.  Bit for bit the
# unsharded steps; an op whose DTensor form differs would be named and
# held within WORLD_ONE_TOL relative.
MESH_BT = (8, 512)
MESH_DECODE_STEPS = 4
WORLD_ONE_TOL = 1e-6

# Phase 15: the port's repro-lint on this checkout's tree; its host-sync
# pass held to the card's own count of synchronizing calls
# (``torch.cuda.set_sync_debug_mode``) for engines on a seeded
# SYNC_POOL at each of SYNC_BUDGETS: an engine the pass finds free of
# in-loop syncs must count the same at every budget.  The phase must end
# within STATIC_LIMIT_S.
SYNC_POOL = (4_096, 22)
SYNC_BUDGETS = (32, 64)
STATIC_LIMIT_S = 30.0

# Phase 16: tree selection over a group of ranks.  (a) MESH_TREE_FANOUTS
# over phase 7's pool cut to its first MESH_TREE_N rows (581,012 = 32 ×
# 18,156 + 20: a DeviceMesh's leaves must split evenly), with phase 11
# (b)'s budgets, computed on the whole pool; (b) the launcher at phase 11
# (c)'s PROC_* with MESH_PROC_FANOUTS.
MESH_TREE_FANOUTS = (8, 4, 1)
MESH_TREE_N = 32 * 18_156
MESH_PROC_FANOUTS = "2,2,1"

# The report's kernels: the TPU kernel each replaces and its CUDA source.
REPLACES = {
    "fl_gains": "src/repro/kernels/fl_gains.py:106",
    "fl_gains_argmax": "src/repro/kernels/fl_gains.py:197",
    "ce_proxy": "src/repro/kernels/ce_proxy.py:113",
    "topk_sim": "src/repro/kernels/topk_sim.py:115",
    "pairwise_l2": "src/repro/kernels/pairwise_l2.py:38",
    "fl_replay": "src/repro/kernels/fl_gains.py:338",
    "adamw_sq_norm": "none: src/repro/optim/optimizers.py:57 (global_norm), left to XLA",
    "adamw_update": "none: src/repro/optim/optimizers.py:153 (adamw's update), left to XLA",
}
SOURCES = {"fl_gains": "src/repro_torch/kernels/csrc/fl_gains.cu",
           "fl_gains_argmax": "src/repro_torch/kernels/csrc/fl_gains.cu",
           "ce_proxy": "src/repro_torch/kernels/csrc/ce_proxy.cu",
           "topk_sim": "src/repro_torch/kernels/csrc/topk_sim.cu",
           "pairwise_l2": "src/repro_torch/kernels/csrc/pairwise_l2.cu",
           "fl_replay": "src/repro_torch/kernels/csrc/fl_replay.cu",
           "adamw_sq_norm": "src/repro_torch/kernels/csrc/adamw.cu",
           "adamw_update": "src/repro_torch/kernels/csrc/adamw.cu"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple[float, float, float]:
    """(fp32, bf16, bytes) a second for the card: ``roofline.PEAKS``."""
    from repro_torch.roofline import PEAKS

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


def occupancy(lib, entry: str, *args) -> tuple[int, int]:
    """(registers per thread, CTAs per SM) from a source's C occupancy entry."""
    import ctypes

    regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
    status = getattr(lib, entry)(*args, ctypes.addressof(regs), ctypes.addressof(ctas))
    if status != 0:
        raise RuntimeError(f"{entry}: cudaError {status}")
    return regs.value, ctas.value


# Issue slots per (row, candidate) pair, counted from each source: (slots a
# feature dim, slots of the epilogue).
ISSUE_SLOTS = {
    # fl_gains.cu: one FFMA a dim plus the shared loads (8 LDS.64 + 2
    # LDS.128 per two dims of 32 pairs, 10/64 a pair-dim); an epilogue of
    # ~14 (norm sum, −2·dot, max, the correctly rounded root of ~8,
    # subtract, relu, accumulate).
    "fl_gains": (1.0 + 10.0 / 64.0, 14.0),
    # topk_sim.cu: 8 LDS.64 + 8 LDS.128 per 4 dims of 32 pairs (16/128 a
    # pair-dim); ~5 for the epilogue (norm sum, −2·dot), the bound compare,
    # a ballot a row and the tile's ring, and the merge's share.
    "topk_sim": (1.0 + 16.0 / 128.0, 5.0),
    # fl_replay.cu: 20 LDS.128 and a swizzle op per 4 dims of 64 pairs
    # (21/256 a pair-dim); ~26 for the epilogue (norms, root, select,
    # park), the walk (~8) and the column sums (2).
    "fl_replay": (1.0 + 21.0 / 256.0, 26.0),
    # pairwise_l2.cu: 8 LDS.64 + 4 LDS.128 per 2 dims of 64 pairs (12/128 a
    # pair-dim); ~13 for the epilogue (norm sum, −2·dot, max, the root of
    # ~9, the column mask and the store).
    "pairwise_l2": (1.0 + 12.0 / 128.0, 13.0),
}


def issue_seconds(torch, kernel: str, n: int, m: int, d: int, sm_clock: float) -> float:
    """A kernel's instruction-issue bound: the pairs' issue slots
    (ISSUE_SLOTS) over the card's warp-instruction rate (4 schedulers an
    SM, one warp instruction of 32 threads each per clock, at the maximum
    SM clock)."""
    per_dim, epilogue = ISSUE_SLOTS[kernel]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = n * m * (d * per_dim + epilogue) / 32.0
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


def hold_argmax(torch, ops, x, cur, sq, d_max, chosen, tile: str, what: str):
    """One ``fl_gains_argmax`` sweep of ``x`` against itself through the
    kernel and the plain twin: gains within ``gain_tol`` (+1e-5 rel), the
    winners equal or a near-tie, never a chosen candidate.  Returns (max
    |Δgain|, the kernel's block partials)."""
    tol = gain_tol(x, x.shape[0], float(d_max), tile == "bfloat16")
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
        raise AssertionError(f"{what}: max |err| {err} > {tol} + 1e-5·{scale}")
    live = torch.where(chosen, float("-inf"), gp)
    wk, wp = int(pi[torch.argmax(pg)]), int(pip[torch.argmax(pgp)])
    if wk != wp and abs(float(live[wk]) - float(live[wp])) > tol:
        raise AssertionError(f"{what}: winner {wk} vs plain {wp} is not a near-tie")
    if bool(chosen[wk]):
        raise AssertionError(f"{what}: a chosen candidate won the sweep")
    return err, pg


def class_positions(np, indices, pool) -> list:
    """The members of ``indices`` in class ``pool`` as positions in it."""
    members = set(pool.tolist())
    return [int(np.searchsorted(pool, i)) for i in indices if int(i) in members]


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
        ia, ib = class_positions(np, a.indices, pool), class_positions(np, b.indices, pool)
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


def ce_route(D: int, lib=None) -> dict:
    """The bf16 route ``ce_proxy`` takes at D (1, 2: the cluster kernel with
    one or two 256-column slices a CTA; 3: SIMT), with its CTAs per cluster
    and how many such clusters the card holds at once; ``lib``: another
    build of the source (default: the committed one)."""
    import ctypes

    from repro_torch.kernels import _build

    lib = lib or _build.library("ce_proxy")
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    status = lib.ce_proxy_bf16_clusters(D, ctypes.addressof(ctas), ctypes.addressof(clusters))
    if status != 0:
        raise RuntimeError(f"ce_proxy_bf16_clusters(D={D}): cudaError {status}")
    return {"route": lib.ce_proxy_bf16_auto_route(D), "cluster_ctas": ctas.value,
            "clusters_at_once": clusters.value}


def ce_bound(T: int, D: int, V: int, es: int, peak: float, mem_bw: float) -> dict:
    """``ce_proxy``'s bound: 4·T·V·D operations at ``peak``, or its bytes
    (h and W of ``es`` bytes an element, int32 labels, the fp32 output)."""
    return bound(4.0 * T * V * D / peak, (es * (T * D + V * D) + 4 * T + 4 * T * D) / mem_bw)


def time_wide_ce(torch, kce, h, w, y, vv, bf16_peak, mem_bw) -> dict:
    """The bf16 kernel beside the einsum head (the library path,
    ``core.proxy.lm_unembed_input_proxy``, on the same tokens as one batch
    of LM_BATCH sequences) and the plain twin, with the bound 4·T·V·D over
    the bf16 peak (or the bytes, if larger)."""
    from repro_torch.core.proxy import lm_unembed_input_proxy

    T, D = h.shape
    V = w.shape[0]
    hb, wb, yb = h.bfloat16(), w.bfloat16(), y.to(torch.int32)
    hid, lab = hb.reshape(LM_BATCH, -1, D), y.reshape(LM_BATCH, -1)
    return {
        "ms": median_ms(torch, lambda: kce.ce_proxy_cuda(hb, wb, yb, vv), 5),
        "einsum_head_ms": median_ms(torch, lambda: lm_unembed_input_proxy(
            hid, wb, lab, chunk=1024, valid_v=vv, compute_dtype=torch.bfloat16), 5),
        "plain_ms": median_ms(torch, lambda: kce.ce_proxy_torch(h, w, y, vv, torch.bfloat16),
                              3, warm=1),
        **ce_bound(T, D, V, 2, bf16_peak, mem_bw), **ce_route(D),
    }


def check_ce_proxy(torch, ops, kce, dev, gen, peaks, card) -> dict:
    """``ce_proxy`` kernel against its plain version in both dtypes at every
    shape of CE_SHAPES (labels include the last valid column), then CUDA-event
    times at the main-path shape, and beside the einsum head at the shapes
    of CE_WIDE and at one shape of the SIMT route.  Returns the report
    entry (bf16, the main path's dtype) and logs the other figures."""
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
        names = [n for n, shape in CE_WIDE.items() if shape == (D, V, vv) and T == 4096]
        if ce_route(D)["route"] == 3:  # the SIMT route, timed at its one shape
            names = ["the SIMT route (not optimised)"]
        if names:
            r = time_wide_ce(torch, kce, h, w, y, vv, bf16_peak, mem_bw)
            log(f"[2] ce_proxy bf16 at {' and '.join(names)} (T={T}, D={D}, V={V}, "
                f"valid_v={vv}): kernel {r['ms']:.3f} ms, einsum head "
                f"{r['einsum_head_ms']:.3f} ms, plain twin {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.3f} ms ({r['bound_by']}); route {r['route']}, "
                f"{r['cluster_ctas']} CTAs a cluster, {r['clusters_at_once']} clusters at "
                f"once; {card}")
        if (T, D, V, vv) != CE_SHAPES[0]:
            continue
        for dname, reps in CE_TIMED.items():
            cd = getattr(torch, dname)
            hc, wc, yc = h.to(cd), w.to(cd), y.to(torch.int32)
            es, peak = (2, bf16_peak) if dname == "bfloat16" else (4, fp32_peak)
            timed[dname] = {
                "ms": median_ms(torch, lambda: kce.ce_proxy_cuda(hc, wc, yc, vv), reps),
                "plain_ms": median_ms(torch, lambda: kce.ce_proxy_torch(h, w, y, vv, cd), reps),
                **ce_bound(T, D, V, es, peak, mem_bw),
            }
            log(f"[2] ce_proxy {dname} at T={T}, D={D}, V={V}: {timed[dname]}")
        log(f"[2] ce_proxy bf16 route at D={D}: {ce_route(D)}")
    return {**timed["bfloat16"], "max_abs_err": max_err["bfloat16"],
            "fp32": {**timed["float32"], "max_abs_err": max_err["float32"]}}


def hold_fused_proxies(torch, cfg, params, batch) -> dict:
    """The fused proxies (the ``ce_proxy`` kernel, bf16) against the einsum
    path on one batch.  Tolerance 2⁻⁵·max|W|: the einsum path also rounds
    its logits and its (p − y) to bf16 where the kernel keeps fp32 (a few
    bf16 ulps of a convex combination of W rows)."""
    from repro_torch.models import proxy_features, proxy_features_fused, unembed_matrix

    fused = proxy_features_fused(params, cfg, batch)
    einsum = proxy_features(params, cfg, batch)
    torch.cuda.synchronize()
    B = batch["labels"].shape[0]
    if fused.shape != (B, cfg.d_model) or not bool(torch.isfinite(fused).all()):
        raise AssertionError(f"{cfg.name} fused proxies: shape {tuple(fused.shape)} or "
                             "non-finite")
    err = float((fused - einsum).abs().max())
    tol = 2.0**-5 * float(unembed_matrix(params).abs().max())
    if err > tol:
        raise AssertionError(f"{cfg.name} fused against einsum proxies: max |err| {err} > {tol}")
    return {"err": err, "tol": tol, "max_g": float(einsum.abs().max())}


def proxy_ms(torch, ops, cfg, params, batch, whole: bool) -> dict:
    """Median ms of PROXY_TIMED calls per batch: the ``ce_proxy`` kernel
    head and the einsum head on the same hidden states (with codebook
    heads: the first codebook's), and with ``whole`` both proxy paths
    forward included."""
    from repro_torch.core.proxy import lm_unembed_input_proxy
    from repro_torch.models import (COMPUTE_DTYPE, forward, proxy_features,
                                    proxy_features_fused, unembed_matrix)

    with torch.no_grad():
        hidden, _ = forward(params, cfg, batch)
        w, labels = unembed_matrix(params), batch["labels"]
        if cfg.n_codebooks > 1:
            w, labels = w[0], labels[..., 0]
        h2, y2 = hidden.reshape(-1, cfg.d_model), labels.reshape(-1)
        fns = {
            "kernel head": lambda: ops.ce_proxy(
                h2, w, y2, valid_v=cfg.vocab_size, compute_dtype=COMPUTE_DTYPE, impl="cuda"),
            "einsum head": lambda: lm_unembed_input_proxy(
                hidden, w, labels, chunk=cfg.logit_chunk, valid_v=cfg.vocab_size,
                compute_dtype=COMPUTE_DTYPE),
        }
        if whole:
            fns["fused (kernel)"] = lambda: proxy_features_fused(params, cfg, batch)
            fns["einsum"] = lambda: proxy_features(params, cfg, batch)
        return {k: round(median_ms(torch, fn, PROXY_TIMED), 3) for k, fn in fns.items()}


def count_params(cfg, params) -> int:
    """The parameters' element count, held to the config's
    (``models.model.stored_param_count``: the reference's ``param_count()``
    with padded vocabulary rows and what it leaves out)."""
    from repro_torch.models.model import stored_param_count

    n = sum(p.numel() for p in params.values())
    expected = stored_param_count(cfg)
    if n != expected:
        raise AssertionError(f"{cfg.name}: {n} parameters, config says {expected}")
    return n


def published_layers(cfg) -> int:
    """The published layer count of ``cfg``'s architecture."""
    from repro_torch.configs import get_config

    return get_config(cfg.name).n_layers


def full_width_proxy_check(torch, ops, card, dev) -> None:
    """qwen3-1.7b at full width, seeded on the card: the fused proxy against
    the einsum path on one 8 × 512 batch (``hold_fused_proxies``), then both
    paths timed per batch, whole (forward included) and head alone (on the
    same hidden states)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, to_device
    from repro_torch.models import init_params

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = count_params(cfg, params)
    ds = TokenStream(n_docs=LM_DOCS, seq_len=LM_SEQ, vocab_size=cfg.vocab_size)
    batch = to_device(ds.batch(np.arange(LM_BATCH)), dev)
    held = hold_fused_proxies(torch, cfg, params, batch)
    log(f"[5] {LM_ARCH} ({n_params:,} params, seeded on the card): fused proxies "
        f"({LM_BATCH}, {cfg.d_model}) against einsum, max |err| {held['err']:.3e} (tol "
        f"{held['tol']:.3e}, max|g| {held['max_g']:.3e}); {time.perf_counter() - t0:.1f}s; "
        f"{card}")
    ms = proxy_ms(torch, ops, cfg, params, batch, whole=True)
    log(f"[5] {LM_ARCH} proxies per {LM_BATCH}×{LM_SEQ} batch, median ms of {PROXY_TIMED} "
        f"(whole = forward + head): {ms}; {card}")
    log(f"[5] head alone at T = {LM_BATCH * LM_SEQ} tokens, D = {cfg.d_model}, V = "
        f"{cfg.padded_vocab}: ce_proxy kernel {ms['kernel head']} ms, einsum head "
        f"{ms['einsum head']} ms ({ms['kernel head'] / ms['einsum head']:.2f}×); {card}")
    del params, batch
    torch.cuda.empty_cache()


def train_lm(torch, ops, card, dev, cfg, docs: int, mode: str, n_steps: int, schedule,
             expect: tuple, tag: str, phase: int = 6, heads: bool = False) -> dict:
    """``Trainer.run`` of ``cfg`` with per-epoch CRAIG refresh over ``docs``
    seeded docs of LM_SEQ tokens, batches of LM_BATCH.  Counts are zeroed
    just before the run and read just after.  ``expect`` is (refreshes,
    installs).  With ``mode='sync'`` the refreshes run inline, so step,
    extraction and selection seconds are measured apart; with ``'async'``
    extraction overlaps training (the trainer's default), and each install
    reports how long its step waited for the selection.  Every step's MoE
    auxiliary loss is recorded (finite and positive for an MoE config).
    With ``heads`` the trained model's fused proxies are then held to the
    einsum proxies and both heads timed (``hold_fused_proxies``,
    ``proxy_ms``).  Returns the run's losses, launches and figures."""
    import numpy as np

    from repro_torch.core.craig import CraigConfig
    from repro_torch.data import TokenStream, to_device
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig

    ds = TokenStream(n_docs=docs, seq_len=LM_SEQ, vocab_size=cfg.vocab_size)
    pool_batches = docs // LM_BATCH
    tcfg = TrainerConfig(
        batch_size=LM_BATCH, select_every_epochs=1,
        craig=CraigConfig(fraction=LM_FRACTION, per_class=False),
        proxy_pool_batches=pool_batches, refresh_mode=mode,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tcfg, ds, adamw(schedule), lambda: init_params(cfg, gen), device=dev)
    n_params = count_params(cfg, trainer.params)
    aux, step = [], trainer.train_step

    def recording_step(*args):
        out = step(*args)
        aux.append(float(out[2]["aux_loss"]))
        return out

    trainer.train_step = recording_step
    torch.cuda.synchronize()
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
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    if cfg.n_experts and not all(math.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"{tag}: MoE aux losses {aux}")
    if (n_refresh, len(installs)) != expect or pending is None:
        raise AssertionError(f"{tag}: {n_refresh} refreshes, {len(installs)} installs, "
                             f"pending {pending is not None}; expected {expect}, one staged")
    sums = [m["weight_sum"] for m in installs]
    sums.append(float(np.sum(pending["weights"], dtype=np.float64)))
    if any(abs(v - docs) > 1e-3 for v in sums):
        raise AssertionError(f"{tag}: Σγ per published selection {sums}, expected {docs}")
    if launches["ce_proxy"] != n_refresh * pool_batches:
        raise AssertionError(f"{tag}: ce_proxy launched {launches}; expected "
                             f"{pool_batches} per refresh × {n_refresh}")
    adamw_launches = {k: launches[k] for k in ADAMW_KERNELS}
    # one of each a step (adamw's clip is 1.0), else a CUDA leaf took the loop
    if set(adamw_launches.values()) != {n_steps}:
        raise AssertionError(f"{tag}: {adamw_launches} launched in {n_steps} steps")
    step_s = statistics.median(m["time_s"] for m in steps[2:])
    refreshes = installs + [{"version": pending["version"], **pending["meta"]}]
    per = [(r["version"], round(r["extract_time_s"], 3), round(r["selection_time_s"], 3))
           for r in refreshes]
    stalls = [round(m["install_stall_s"], 3) for m in installs]
    aux_txt = f"; aux loss {aux[0]:.4f} → {aux[-1]:.4f}" if cfg.n_experts else ""
    log(f"[{phase}] {tag}: {cfg.name} ({cfg.n_layers} of {published_layers(cfg)} layers, "
        f"{n_params:,} params) Trainer.run, refresh_mode={mode!r}: {n_steps} steps of "
        f"{LM_BATCH}×{LM_SEQ} tokens in {total_s:.1f}s; loss {losses[0]:.4f} → "
        f"{losses[-1]:.4f}{aux_txt}; coreset {installs[-1]['coreset_size']}/{docs} docs; Σγ "
        f"per published selection {sums}; launches {launches}")
    log(f"[{phase}] {tag}: median {step_s:.4f} s/step ({LM_BATCH * LM_SEQ / step_s:.0f} "
        f"tokens/s); per refresh (version, extract s, select s): {per}; install stalls "
        f"{stalls} s; max_memory_allocated {peak_gb:.2f} GB; {card}")
    out = {"losses": losses, "launches": launches["ce_proxy"], "adamw": adamw_launches}
    if heads:
        batch = to_device(ds.batch(np.arange(LM_BATCH)), dev)
        held = hold_fused_proxies(torch, cfg, trainer.params, batch)
        ms = proxy_ms(torch, ops, cfg, trainer.params, batch, whole=False)
        log(f"[{phase}] {tag}: the trained model's fused proxies against einsum, max |err| "
            f"{held['err']:.3e} (tol {held['tol']:.3e}); heads per {LM_BATCH}×{LM_SEQ} batch, "
            f"median ms of {PROXY_TIMED} at D = {cfg.d_model}, V = {cfg.padded_vocab}: {ms}; "
            f"{card}")
        del batch
    del trainer
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    if left_gb > FREED_GB:
        raise AssertionError(f"{tag}: {left_gb:.2f} GB still allocated after the "
                             "trainer was deleted")
    return out


def refresh_forward_only(torch, ops, card, dev, cfg, docs: int, tag: str) -> dict:
    """One CRAIG refresh of ``cfg`` without an optimizer, through the
    trainer's own parts: ``ProxyExtractor`` over ``make_select_step`` (the
    ``ce_proxy`` kernel on the card) and ``CraigSelector``.  Counts are
    zeroed just before and read just after.  Then the fused proxies held
    to the einsum proxies, both heads timed, and one batch's loss and MoE
    auxiliary loss."""
    import numpy as np

    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.extract import ProxyExtractor
    from repro_torch.data import TokenStream, to_device
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.train_step import make_select_step

    ds = TokenStream(n_docs=docs, seq_len=LM_SEQ, vocab_size=cfg.vocab_size)
    pool_batches = docs // LM_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = count_params(cfg, params)
    extractor = ProxyExtractor(make_select_step(cfg), ds, LM_BATCH, megabatch=pool_batches)
    torch.cuda.synchronize()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    feats = extractor.extract(params, np.arange(docs))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sel = CraigSelector(CraigConfig(fraction=LM_FRACTION, per_class=False),
                        device=dev).select(feats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    if feats.shape != (docs, cfg.d_model) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"{tag}: features {tuple(feats.shape)} or non-finite")
    if launches["ce_proxy"] != pool_batches:
        raise AssertionError(f"{tag}: ce_proxy launched {launches}; expected {pool_batches}")
    wsum = float(np.sum(sel.weights, dtype=np.float64))
    if abs(wsum - docs) > 1e-3 or len(np.unique(sel.indices)) != sel.size:
        raise AssertionError(f"{tag}: Σγ {wsum} (expected {docs}) or duplicate indices")
    batch = to_device(ds.batch(np.arange(LM_BATCH)), dev)
    with torch.no_grad():
        _, m = loss_fn(params, cfg, batch)
    loss, aux = float(m["loss"]), float(m["aux_loss"])
    if not math.isfinite(loss) or (cfg.n_experts and not (math.isfinite(aux) and aux > 0)):
        raise AssertionError(f"{tag}: loss {loss}, aux loss {aux}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[9] {tag}: {cfg.name} ({cfg.n_layers} of {published_layers(cfg)} layers, "
        f"{n_params:,} params, forward only) one refresh of {docs} docs: extract "
        f"{t1 - t0:.3f}s, select {t2 - t1:.3f}s; coreset {sel.size}/{docs}, Σγ {wsum:.0f}; "
        f"launches {launches}; loss {loss:.4f}, aux loss {aux:.4f}; max_memory_allocated "
        f"{peak_gb:.2f} GB; {card}")
    held = hold_fused_proxies(torch, cfg, params, batch)
    ms = proxy_ms(torch, ops, cfg, params, batch, whole=False)
    log(f"[9] {tag}: fused proxies against einsum, max |err| {held['err']:.3e} (tol "
        f"{held['tol']:.3e}); heads per {LM_BATCH}×{LM_SEQ} batch, median ms of "
        f"{PROXY_TIMED} at D = {cfg.d_model}, V = {cfg.padded_vocab}: {ms}; {card}")
    del params, feats, batch, extractor
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    if left_gb > FREED_GB:
        raise AssertionError(f"{tag}: {left_gb:.2f} GB still allocated after the refresh")
    return {"launches": launches["ce_proxy"]}


def wide_lm_training(torch, ops, card, dev) -> dict:
    """Phase 9: each config of WIDE_LM at its published width with depth
    cut, on the seeded token stream (WIDE_DOCS docs): ``train_lm`` through
    two inline refreshes and one install, or ``refresh_forward_only``;
    every refresh launches ``ce_proxy`` once a pool batch at the config's
    (D, padded V).  Then the ``launch/train.py`` subprocess.  Returns the
    figures per config."""
    from repro_torch.configs import get_config
    from repro_torch.optim import warmup_cosine

    t0 = time.perf_counter()
    out = {}
    for name, (layers, train) in WIDE_LM.items():
        cfg = dataclasses.replace(get_config(name), n_layers=layers)
        if (cfg.d_model, cfg.padded_vocab, cfg.vocab_size) != CE_WIDE[name]:
            raise AssertionError(f"{name}: CE_WIDE {CE_WIDE[name]} is not the config's shape")
        tc = time.perf_counter()
        if train:
            out[name] = train_lm(torch, ops, card, dev, cfg, WIDE_DOCS, "sync", WIDE_STEPS,
                                 warmup_cosine(WIDE_LR, 2, WIDE_STEPS), (2, 1),
                                 "published width", phase=9, heads=True)
        else:
            out[name] = refresh_forward_only(torch, ops, card, dev, cfg, WIDE_DOCS,
                                             "published width")
        log(f"[9] {name}: {time.perf_counter() - tc:.1f}s")
    for name, (layers, steps) in WIDE_EMB.items():
        out[name] = emb_lm_training(torch, ops, card, dev, name, layers, steps)
    t1 = time.perf_counter()
    remat_policies(torch, card, dev)
    log(f"[9] remat: {time.perf_counter() - t1:.1f}s")
    train_round_trip(card)
    log(f"[9] phase total {time.perf_counter() - t0:.1f}s")
    return out


def zipf_labels(torch, cfg, dev, shape: tuple, gen):
    """Seeded labels with a Zipf marginal over the real vocabulary (p(k) ∝
    1/(k + 1)): a stub frontend's batches carry no token stream, and a
    skewed marginal is what a model learns first, so the loss falls within
    a few steps."""
    p = 1.0 / torch.arange(1, cfg.vocab_size + 1, device=dev, dtype=torch.float32)
    n = math.prod(shape)
    return torch.multinomial(p / p.sum(), n, replacement=True, generator=gen).reshape(shape)


def emb_batches(torch, cfg, dev, n: int, seed: int) -> list:
    """``n`` seeded batches of LM_BATCH × LM_SEQ in the reference's
    ``train_batch_struct`` layout: ``embeddings`` (B, T, D) bf16,
    ``labels`` (B, T) or (B, T, C), under M-RoPE ``positions`` (B, 3, T)
    holding an image grid (TRAIN_GRID), ``weights`` (B,) of ones."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (LM_BATCH, LM_SEQ) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    out = []
    for _ in range(n):
        b = {"embeddings": torch.randn(LM_BATCH, LM_SEQ, cfg.d_model, device=dev,
                                       generator=gen).to(torch.bfloat16),
             "labels": zipf_labels(torch, cfg, dev, shape, gen),
             "weights": torch.ones(LM_BATCH, device=dev)}
        if cfg.mrope_sections is not None:
            b["positions"] = grid_positions(torch, dev, LM_BATCH, *TRAIN_GRID)
        out.append(b)
    return out


def emb_lm_training(torch, ops, card, dev, name: str, layers, steps: int) -> dict:
    """Phase 9, a stub-frontend config at published width: ``steps``
    full-data steps of ``make_train_step`` on seeded batches, one CRAIG
    selection over a WIDE_DOCS-doc pool of such batches (``make_select_step``:
    one ``ce_proxy`` launch a batch and codebook; ``CraigSelector``, Σγ =
    WIDE_DOCS), then γ-weighted steps on the coreset.  Counts are zeroed
    just before the selection and read just after.  Gates: finite losses
    that fall, the launches, Σγ, and the trained model's fused proxies
    held to the einsum proxies (``hold_fused_proxies``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train.train_step import make_select_step, make_train_step

    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if (cfg.d_model, cfg.padded_vocab, cfg.vocab_size) != CE_WIDE[name]:
        raise AssertionError(f"{name}: CE_WIDE {CE_WIDE[name]} is not the config's shape")
    tag = "published width"
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = count_params(cfg, params)
    pool_batches = WIDE_DOCS // LM_BATCH
    pool = emb_batches(torch, cfg, dev, pool_batches, 1)
    train = emb_batches(torch, cfg, dev, steps, 2)
    n_core = round(LM_FRACTION * WIDE_DOCS)
    opt = adamw(warmup_cosine(WIDE_LR, 2, steps + -(-n_core // LM_BATCH)))
    state = opt.init(params)
    step = make_train_step(cfg, opt)

    def held_loss():  # the first batch's loss, the same tokens before and after
        with torch.no_grad():
            return float(loss_fn(params, cfg, train[0])[1]["loss"])

    before = held_loss()
    losses, times = [], []
    for b in train:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - ts)
    after = held_loss()
    select = make_select_step(cfg)
    torch.cuda.synchronize()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    ts = time.perf_counter()
    with torch.no_grad():
        feats = torch.cat([select(params, b) for b in pool])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - ts
    sel = CraigSelector(CraigConfig(fraction=LM_FRACTION, per_class=False), device=dev).select(feats)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - ts - extract_s
    launches = dict(ops.LAUNCHES)
    if feats.shape != (WIDE_DOCS, cfg.d_model) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"{name}: features {tuple(feats.shape)} or non-finite")
    if launches["ce_proxy"] != pool_batches * cfg.n_codebooks:
        raise AssertionError(f"{name}: ce_proxy launched {launches}; expected {pool_batches} "
                             f"batches × {cfg.n_codebooks} codebooks")
    wsum = float(np.sum(sel.weights, dtype=np.float64))
    if abs(wsum - WIDE_DOCS) > 1e-3 or sel.size != n_core:
        raise AssertionError(f"{name}: coreset {sel.size} (want {n_core}), Σγ {wsum}")
    # γ-weighted steps on the coreset, LM_BATCH docs a step, in greedy order
    idx = torch.as_tensor(sel.indices, device=dev)
    gamma = torch.as_tensor(sel.weights, device=dev, dtype=torch.float32)
    docs = {k: torch.cat([b[k] for b in pool]) for k in pool[0]}
    for lo in range(0, sel.size, LM_BATCH):
        rows = idx[lo:lo + LM_BATCH]
        b = {k: v[rows] for k, v in docs.items()}
        b["weights"] = gamma[lo:lo + LM_BATCH]
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    if not all(math.isfinite(v) for v in losses) or not after < before:
        raise AssertionError(f"{name}: step losses {losses}; first batch's loss {before} → "
                             f"{after} over the full-data steps")
    held = hold_fused_proxies(torch, cfg, params, train[0])
    ms = proxy_ms(torch, ops, cfg, params, train[0], whole=False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(times[2:])
    log(f"[9] {tag}: {name} ({cfg.n_layers} of {published_layers(cfg)} layers, {n_params:,} "
        f"params) make_train_step on seeded {LM_BATCH}×{LM_SEQ} embeddings batches"
        f"{' with image-grid positions' if cfg.mrope_sections else ''}, labels "
        f"{tuple(train[0]['labels'].shape)}: {steps} full-data steps, loss {losses[0]:.4f} → "
        f"{losses[steps - 1]:.4f} (the first batch's {before:.4f} → {after:.4f}), median "
        f"{step_s:.4f} s/step; select over {WIDE_DOCS} docs: "
        f"extract {extract_s:.3f}s ({launches['ce_proxy']} ce_proxy launches), select "
        f"{select_s:.3f}s, coreset {sel.size}, Σγ {wsum:.0f}; {len(losses) - steps} γ-weighted "
        f"steps, loss → {losses[-1]:.4f}; max_memory_allocated {peak_gb:.2f} GB; {card}")
    log(f"[9] {tag}: {name} fused proxies against einsum, max |err| {held['err']:.3e} (tol "
        f"{held['tol']:.3e}); heads per {LM_BATCH}×{LM_SEQ} batch and codebook, median ms of "
        f"{PROXY_TIMED} at D = {cfg.d_model}, V = {cfg.padded_vocab}: {ms}; "
        f"{time.perf_counter() - t0:.1f}s; {card}")
    del params, state, pool, train, docs, feats
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    if left_gb > FREED_GB:
        raise AssertionError(f"{name}: {left_gb:.2f} GB still allocated after training")
    return {"launches": launches["ce_proxy"]}


def remat_policies(torch, card, dev) -> None:
    """Phase 9, remat on the card: one qwen3-1.7b training step of LM_BATCH
    × LM_SEQ seeded tokens under each of REMAT_POLICIES, the same weights
    and batch, each after a warm-up step.  Gates: equal losses; gradients
    within REMAT_TOL·max|g| of 'nothing''s per tensor.  Logs each policy's
    step time and peak memory ('dots' keeps each layer's x @ W outputs, so
    its peak is expected between the other two)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, to_device
    from repro_torch.models import init_params, loss_fn

    cfg0 = get_config(LM_ARCH)
    params = init_params(cfg0, torch.Generator(device=dev).manual_seed(0))
    ds = TokenStream(n_docs=LM_BATCH, seq_len=LM_SEQ, vocab_size=cfg0.vocab_size)
    batch = to_device(ds.batch(np.arange(LM_BATCH)), dev)
    names = list(params)
    ref, out = None, {}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        for rep in range(2):
            grads = None  # free the warm-up's before the timed step
            leaves = [params[k].detach().requires_grad_(True) for k in names]
            torch.cuda.synchronize()
            base_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            total, _ = loss_fn(dict(zip(names, leaves)), cfg, batch)
            grads = torch.autograd.grad(total, leaves)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
            del leaves
        loss = total.item()
        if ref is None:
            ref = (loss, grads)
            err = 0.0
        else:
            if loss != ref[0]:
                raise AssertionError(f"remat {policy!r}: loss {loss} != {ref[0]} ('nothing')")
            err = max(float((g - r).abs().max()) / (float(r.abs().max()) + 1e-30)
                      for g, r in zip(grads, ref[1]))
            if err > REMAT_TOL:
                raise AssertionError(f"remat {policy!r}: gradients {err:.3e} of max|g| off "
                                     f"'nothing''s (tol {REMAT_TOL})")
            del grads
        out[policy] = (secs, peak_gb, err)
    log(f"[9] remat on {LM_ARCH} ({cfg0.n_layers} layers), one step of {LM_BATCH}×{LM_SEQ} "
        f"tokens, loss {ref[0]:.6f} under every policy; (s a step, peak GB above the weights "
        f"and batch, max gradient difference from 'nothing' / max|g|): "
        f"{ {p: (round(a, 4), round(b, 2), float(f'{c:.3e}')) for p, (a, b, c) in out.items()} }; "
        f"{card}")
    del params, ref, batch
    torch.cuda.empty_cache()


def train_round_trip(card) -> None:
    """``python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b
    --smoke --device cuda --steps 12`` in a subprocess: exits 0 and reports
    its 12 steps."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "moonshot-v1-16b-a3b",
         "--smoke", "--device", "cuda", "--steps", "12"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=300,
    )
    if proc.returncode != 0 or "12 steps in" not in proc.stdout:
        raise AssertionError(f"launch/train.py exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    log(f"[9] launch/train.py --arch moonshot-v1-16b-a3b --smoke --device cuda --steps 12: "
        f"{' | '.join(proc.stdout.strip().splitlines())} ({time.perf_counter() - t0:.1f}s, "
        f"process start included); {card}")


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


def adamw_leaves(torch, dev, shapes: dict, seed: int, unaligned: bool = False) -> dict:
    """Seeded fp32 leaves of ``shapes`` on the card; with ``unaligned`` one
    more leaf that starts 4 bytes past a 16-byte boundary."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {k: 0.02 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    if unaligned:
        out["unaligned"] = torch.randn(70_001, device=dev, generator=gen)[1:]
    return out


def hold_adamw(torch, dev, params: dict, grad_scale: float, clip, wd: float, tag: str,
               mesh=None) -> dict:
    """ADAMW_STEPS steps of ``optim.adamw`` (the kernels) on ``params`` and of
    the plain twin (``adamw_loop``) on a copy, the same seeded gradients each
    step; on a ``mesh`` the kernels' leaves are DTensors (2-D and larger
    leaves split on its "model" dim, the rest replicated).  Each step's
    gradients also go through ``adamw_sq_norm`` alone, its √Σ partials held
    to ``global_norm``.  Returns the largest max|Δ| and max|Δ| / max|twin|
    of p, m and v over the leaves, and the norm's largest |Δ| and |Δ| /
    norm; raises past ADAMW_TOL (relative) or when a step does not launch
    ``adamw_update`` once."""
    from repro_torch.kernels import adamw as kadam
    from repro_torch.optim import adamw, constant, global_norm
    from repro_torch.optim.optimizers import adamw_loop

    lr, b1, b2, eps = 1e-2, 0.9, 0.999, 1e-8
    twin = {k: p.clone() for k, p in params.items()}
    tm = {k: torch.zeros_like(p) for k, p in params.items()}
    tv = {k: torch.zeros_like(p) for k, p in params.items()}
    if mesh is not None:
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        def placed(t):
            pl = [Replicate(), Shard(0) if t.dim() > 1 else Replicate()]
            return distribute_tensor(t, mesh, pl, src_data_rank=None)
    else:
        def placed(t):
            return t
    params = {k: placed(p) for k, p in params.items()}
    opt = adamw(constant(lr), b1=b1, b2=b2, eps=eps, weight_decay=wd, clip=clip)
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(31)
    norm_abs = norm_rel = 0.0
    for i in range(ADAMW_STEPS):
        grads = {k: grad_scale * torch.randn(t.shape, device=dev, generator=gen)
                 for k, t in twin.items()}
        norm = float(torch.sqrt(kadam._sq_norm_op(list(grads.values())).sum()))
        want = float(global_norm(grads))
        norm_abs = max(norm_abs, abs(norm - want))
        norm_rel = max(norm_rel, abs(norm - want) / want)
        before = kadam.LAUNCHES["adamw_update"]
        params, state = opt.update({k: placed(g.clone()) for k, g in grads.items()},
                                   state, params)
        if kadam.LAUNCHES["adamw_update"] != before + 1:
            raise AssertionError(f"adamw {tag}: step {i} launched adamw_update "
                                 f"{kadam.LAUNCHES['adamw_update'] - before} times")
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** (i + 1))
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** (i + 1))
        adamw_loop(twin, grads, tm, tv, lr=lr, b1=b1, b2=b2, bc1=bc1, bc2=bc2, eps=eps,
                   weight_decay=wd, clip=clip)
    torch.cuda.synchronize()

    def full(t):
        return t.full_tensor() if mesh is not None else t

    out = {"norm_abs": norm_abs, "norm_rel": norm_rel}
    for what, got, want in (("p", params, twin), ("m", state.inner["m"], tm),
                            ("v", state.inner["v"], tv)):
        gaps = [(float((full(got[k]) - want[k]).abs().max()), float(want[k].abs().max()))
                for k in want if want[k].numel()]
        out[f"{what}_abs"] = max(d for d, _ in gaps)
        out[f"{what}_rel"] = max(d / (w + 1e-30) for d, w in gaps)
    rel = {k: v for k, v in out.items() if k.endswith("_rel")}
    if max(rel.values()) > ADAMW_TOL:
        raise AssertionError(f"adamw {tag}: kernels against the twin {rel} > {ADAMW_TOL}")
    return out


def time_adamw(torch, dev, name: str, layers: int, mem_bw: float) -> dict:
    """Both passes at a benchmark configuration's full leaf set, CUDA-event
    timed beside their byte bounds; beside them the plain code each
    replaces (``global_norm``; the loop without its clip, and with it), the
    library's multi-tensor calls, which the port never makes
    (``torch._foreach_norm``; ``torch._fused_adamw_``, which cannot clip),
    and the whole ``update`` (host and both passes); the norm pass's √Σ
    partials held to ``global_norm`` on the same gradients; the allocator's
    rise during an update and the host's enqueue time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as kadam
    from repro_torch.models.model import param_shapes
    from repro_torch.optim import adamw, constant, global_norm
    from repro_torch.optim.optimizers import adamw_loop

    shapes = param_shapes(dataclasses.replace(get_config(name), n_layers=layers))
    n = sum(math.prod(s) for s in shapes.values())
    params = adamw_leaves(torch, dev, shapes, 7)
    gen = torch.Generator(device=dev).manual_seed(8)
    grads = {k: 1e-4 * torch.randn(s, device=dev, generator=gen) for k, s in shapes.items()}
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    opt = adamw(constant(3e-5), clip=1.0, **hyper)
    state = opt.init(params)
    m, v = state.inner["m"], state.inner["v"]
    P, G, M, V = (list(d.values()) for d in (params, grads, m, v))
    opt.update(grads, state, params)  # the chunk list, the library
    torch.cuda.synchronize()
    before = kadam.LAUNCHES["adamw_update"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    opt.update(grads, state, params)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    if kadam.LAUNCHES["adamw_update"] != before + 1:
        raise AssertionError(f"adamw at {name}: {kadam.LAUNCHES['adamw_update'] - before} "
                             "adamw_update launches in one update")
    if rise >= ADAMW_RISE_MB * 2**20:
        raise AssertionError(f"adamw at {name}: an update raised the allocator's high-water "
                             f"mark by {rise / 2**20:.1f} MB")
    partials = kadam._sq_norm_op(G)
    norm, want = float(torch.sqrt(partials.sum())), float(global_norm(grads))
    if abs(norm - want) > ADAMW_TOL * want:
        raise AssertionError(f"adamw at {name}: the norm pass's {norm} against "
                             f"global_norm's {want}")
    steps = [torch.ones((), device=dev) for _ in P]
    lib = dict(lr=3e-5, beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
               maximize=False)
    r = {
        "leaves": len(shapes), "params": n, "norm_abs_err": abs(norm - want),
        "norm_rel_err": abs(norm - want) / want,
        "sq_norm_ms": median_ms(torch, lambda: kadam._sq_norm_op(G), reps=10),
        "update_ms": median_ms(torch, lambda: kadam._update_op(
            P, M, V, G, partials, 3e-5, 0.9, 0.999, 0.5, 0.5, 1e-8, 0.0, 1.0), reps=10),
        "step_ms": median_ms(torch, lambda: opt.update(grads, state, params), reps=10),
        "sq_norm_bound_ms": 1e3 * 4 * n / mem_bw, "update_bound_ms": 1e3 * 28 * n / mem_bw,
        "host_ms": host_ms, "rise_mb": rise / 2**20,
        "sq_norm_plain_ms": median_ms(torch, lambda: global_norm(grads), reps=10),
        "sq_norm_library_ms": median_ms(torch, lambda: torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(G))), reps=10),
        "update_library_ms": median_ms(torch, lambda: torch._fused_adamw_(
            P, G, M, V, [], steps, **lib), reps=10),
    }
    del partials
    r["update_plain_ms"] = median_ms(torch, lambda: adamw_loop(
        params, grads, m, v, lr=3e-5, bc1=0.5, bc2=0.5, clip=None, **hyper), reps=3, warm=1)
    r["loop_ms"] = median_ms(torch, lambda: adamw_loop(
        params, grads, m, v, lr=3e-5, bc1=0.5, bc2=0.5, clip=1.0, **hyper), reps=3, warm=1)
    return r


def check_adamw(torch, card, dev, mem_bw: float) -> dict:
    """AdamW's two kernels against the plain twin on the card: ragged leaves
    (clip engaged, set but idle, and off; weight decay on and off), a slice
    of qwen2-7b's leaf set (the embedding, one layer with its biases and
    norm scales, the final norm) with the clip engaged and off, and ragged
    leaves as DTensors of a (1, 1) mesh over NCCL in a group of one; then
    both passes timed at the benchmark's leaf sets (ADAMW_CUTS).  Returns
    the report's rows for ``adamw_sq_norm`` and ``adamw_update`` at
    qwen2-7b's leaf set, without launches: those are counted on the main
    path (phases 6, 9 and 10).  ``max_abs_err`` is the norm's largest
    |√Σ partials − global_norm|, and the update's largest |kernel − twin|
    over p, m and v."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.models.model import param_shapes

    t0 = time.perf_counter()
    ragged = {f"leaf{i}": (n,) for i, n in enumerate(ADAMW_RAGGED)}
    ragged["matrix"] = (129, 257)
    worst: dict = {}

    def keep(w, tag):
        for k, x in w.items():
            worst[k] = max(worst.get(k, 0.0), x)
        log(f"[2] adamw {tag}: kernels against the twin, max |Δ| and max |Δ| / max |twin| "
            f"of p, m, v, and the norm's |Δ| and |Δ| / norm: {w}")

    for tag, scale, clip, wd in (("ragged, clip engaged", 3.0, 1.0, 0.0),
                                 ("ragged, clip set, not engaged", 1e-5, 1.0, 0.01),
                                 ("ragged, no clip", 3.0, None, 0.01)):
        keep(hold_adamw(torch, dev, adamw_leaves(torch, dev, ragged, 1, unaligned=True),
                        scale, clip, wd, tag), tag)
    shapes = param_shapes(dataclasses.replace(get_config("qwen2-7b"), n_layers=1))
    sliced = {k: s for k, s in shapes.items() if k != "unembed"}
    for tag, clip in (("qwen2-7b slice, clip engaged", 1.0), ("qwen2-7b slice, no clip", None)):
        keep(hold_adamw(torch, dev, adamw_leaves(torch, dev, sliced, 2), 1e-3, clip, 0.0,
                        f"{tag} ({len(sliced)} leaves)"), tag)
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        tag = "ragged on a (1, 1) mesh, clip engaged"
        keep(hold_adamw(torch, dev, adamw_leaves(torch, dev, ragged, 3), 3.0, 1.0, 0.0, tag,
                        mesh=mesh), tag)
    finally:
        dist.destroy_process_group()
    timed = {}
    for name, layers in ADAMW_CUTS.items():
        timed[name] = time_adamw(torch, dev, name, layers, mem_bw)
        log(f"[2] adamw at {name} ({layers} layers): {timed[name]}; {card}")
        worst["norm_abs"] = max(worst["norm_abs"], timed[name]["norm_abs_err"])
        torch.cuda.empty_cache()
    log(f"[2] adamw: {time.perf_counter() - t0:.1f}s; worst over the holds {worst}")
    q = timed["qwen2-7b"]
    errs = {"sq_norm": worst["norm_abs"], "update": max(worst[f"{w}_abs"] for w in "pmv")}
    return {k: {"max_abs_err": errs[part], "ms": q[f"{part}_ms"],
                "plain_ms": q[f"{part}_plain_ms"], "library_ms": q[f"{part}_library_ms"],
                "bound_ms": q[f"{part}_bound_ms"], "bound_by": "bytes"}
            for k, part in zip(ADAMW_KERNELS, ("sq_norm", "update"))}


def coverage64(torch, x, idx, block: int = 8192) -> float:
    """L(S) = Σ_i min_{j∈S} ‖x_i − x_j‖ in fp64, row block by row block."""
    xs = x[torch.as_tensor(idx, device=x.device)].double()
    return sum(float(torch.cdist(x[lo:lo + block].double(), xs).min(dim=1).values.sum())
               for lo in range(0, x.shape[0], block))


def hold_sparse_selection(torch, x, a, b, label: str) -> str:
    """Hold sparse selection ``a`` to ``b`` under the tie rule: equal
    indices and γ, or — after a near-tie flip in the graph — fp64
    objectives within 1e-3.  Returns the verdict."""
    import numpy as np

    if np.array_equal(a.indices, b.indices):
        if not np.array_equal(a.weights, b.weights):
            raise AssertionError(f"{label}: same medoids, different γ")
        return "identical indices and γ"
    ca, cb = coverage64(torch, x, a.indices), coverage64(torch, x, b.indices)
    if abs(ca - cb) > 1e-3 * max(ca, cb):
        raise AssertionError(f"{label}: objectives {ca} and {cb} differ by more than 1e-3")
    return f"indices differ after a near-tie; fp64 L(S) {ca:.4f} vs {cb:.4f}"


def product_ms(torch, x, y, block: int) -> float:
    """CUDA-event time of the cuBLAS fp32 product x·yᵀ (TF32 off) in column
    blocks of ``block``: the product alone, at a redesigned kernel's shape."""
    def run():
        for lo in range(0, y.shape[0], block):
            torch.mm(x, y[lo:lo + block].T)
    return median_ms(torch, run, 3, warm=1)


def design_figures(torch, kernel: str, n: int, m: int, d: int) -> dict:
    """A redesigned kernel's issue bound (ISSUE_SLOTS) and its registers and
    CTAs per SM (from its C occupancy entry) at a main-path shape."""
    from repro_torch.kernels import _build

    lib = _build.library(kernel)
    if kernel == "topk_sim":
        regs, ctas = occupancy(lib, "topk_sim_occupancy", d, COV_K)
    elif kernel == "pairwise_l2":
        regs, ctas = occupancy(lib, "pairwise_l2_occupancy", d)
    else:
        regs, ctas = occupancy(lib, "fl_replay_occupancy")
    return {"issue_bound_ms": 1e3 * issue_seconds(torch, kernel, n, m, d, max_sm_clock_hz()),
            "registers": regs, "ctas_per_sm": ctas}


def covtype_pool(dev):
    """The Covtype-shaped pool: (features on ``dev``, numpy labels)."""
    import numpy as np

    from repro_torch.core.proxy import convex_feature_proxy
    from repro_torch.data.synthetic import make_classification

    x_np, y = make_classification(COV_N, COV_D, COV_CLASSES, seed=0)
    x_np = x_np / np.abs(x_np).max()
    if {int(c): int(k) for c, k in zip(*np.unique(y, return_counts=True))} != COV_SIZES:
        raise AssertionError("make_classification no longer gives the Covtype-shaped sizes")
    return convex_feature_proxy(x_np, device=dev), y


def covtype_selection(torch, ops, card, dev, peaks, feats, y) -> dict:
    """Slice 3's first path: per-class CRAIG on the Covtype-shaped pool
    (``covtype_pool``) with engine='auto' (the sparse engine), then two
    epochs of weighted IG.  Returns the report entries of ``topk_sim`` and
    ``pairwise_l2``."""
    import numpy as np

    from repro_torch.core import engines as E
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.engines import sparse
    from repro_torch.examples.quickstart import logistic, schedule_for
    from repro_torch.kernels import _build, pairwise_l2 as kpw, topk_sim as ktk
    from repro_torch.optim import ig_run

    fp32_peak, _, mem_bw = peaks
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
    log(f"[7] topk_sim at class 0, beside it: {design_figures(torch, 'topk_sim', n0, n0, COV_D)}; "
        f"product_ms {product_ms(torch, x0, x0, 8192):.3f} (cuBLAS fp32 x·xᵀ in column "
        f"blocks of 8,192, TF32 off; not the same function)")
    # k past the register lists, as an extra record (not on the main path)
    t256 = median_ms(torch, lambda: ktk.topk_sim_cuda(x0, sq0, dm0, 256), 2, warm=1)
    regs, ctas = occupancy(_build.library("topk_sim"), "topk_sim_occupancy", COV_D, 256)
    log(f"[7] topk_sim at class 0 with k=256 (lists in the outputs' rows): {t256:.3f} ms; "
        f"{regs} registers, {ctas} CTAs/SM; {card}")

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
    log(f"[7] pairwise_l2 beside it: {design_figures(torch, 'pairwise_l2', rows, r0, COV_D)}; "
        f"{card}")

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
    a = runs["cuda"]
    verdict6 = hold_sparse_selection(torch, x6, a, runs["torch"], "class 6")
    log(f"[7] class 6 ({len(pool6)} × {COV_D}, r={a.size}) through both routes: kernels "
        f"{runs['cuda_s']:.3f}s, plain {runs['torch_s']:.3f}s; {verdict6}")

    # k = 256 through the normal entry point (bench_selection.py's
    # _sparse_parity shape): the card's selection against the CPU's
    rng = np.random.RandomState(0)
    centers = rng.randn(32, 32).astype(np.float32) * 4.0
    xs_np = centers[rng.randint(0, 32, 2048)] + rng.randn(2048, 32).astype(np.float32)
    cfg256 = CraigConfig(fraction=0.05, engine=E.SparseConfig(k=256), per_class=False)
    before = ops.LAUNCHES["topk_sim"]
    a = CraigSelector(cfg256, device=dev).select(xs_np)
    torch.cuda.synchronize()
    if ops.LAUNCHES["topk_sim"] != before + 1:
        raise AssertionError("SparseConfig(k=256) on the card did not launch topk_sim")
    b = CraigSelector(cfg256, device="cpu").select(xs_np)
    verdict256 = hold_sparse_selection(torch, torch.as_tensor(xs_np, device=dev), a, b,
                                       "SparseConfig(k=256)")
    log(f"[7] SparseConfig(k=256) selection of 2,048 × 32 (32 clusters, fraction 0.05) on the "
        f"card (one topk_sim launch) against the CPU's: {verdict256}; Σγ "
        f"{float(np.sum(a.weights, dtype=np.float64)):.0f}")

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


def service_deltas(torch, dev) -> list:
    """The service's seeded deltas: SVC_DELTAS × (SVC_ROWS, SVC_DIM) rows of
    a SVC_CLUSTERS-component Gaussian mixture, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(1)
    centers = torch.randn(SVC_CLUSTERS, SVC_DIM, device=dev, generator=gen)
    deltas = []
    for _ in range(SVC_DELTAS):
        comp = torch.randint(0, SVC_CLUSTERS, (SVC_ROWS,), device=dev, generator=gen)
        deltas.append(centers[comp] + 0.5 * torch.randn(SVC_ROWS, SVC_DIM, device=dev,
                                                        generator=gen))
    return deltas


def coreset_service(torch, ops, card, dev, peaks) -> dict:
    """Slice 3's second path: the streaming coreset service on the card.
    Every drain finalizes through ``fl_replay``; the four installed
    selections are held to the dense finalize.  Returns the report entry
    of ``fl_replay``."""
    from repro_torch.core.engines import streaming
    from repro_torch.kernels import fl_gains as kfl
    from repro_torch.serve import CoresetService

    fp32_peak, _, mem_bw = peaks
    deltas = service_deltas(torch, dev)
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
    log(f"[8] fl_replay beside it: {design_figures(torch, 'fl_replay', n, m, SVC_DIM)}; "
        f"product_ms {product_ms(torch, pool, e, m):.3f} (cuBLAS fp32 x·eᵀ, TF32 off; not "
        f"the same function)")
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
    replayed = min(int(st.count[int(torch.argmax(st.fval))]), sel.budget)
    out = {"version": version, "n": pool.shape[0], "replayed": replayed,
           "backfill": sel.budget - replayed}
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
    near = near_tie_rows(torch, pool, med)
    dgamma = float((got.weights - want.weights).abs().sum())
    if dgamma > 2 * near:
        raise AssertionError(f"v{version}: Σ|Δγ| = {dgamma} with {near} near-tie rows")
    gerr = hold_gains(torch, got.gains, want.gains, dist_tol(torch, pool), f"v{version}")
    out.update(indices="equal",
               gamma="equal" if dgamma == 0 else f"Σ|Δγ|={dgamma:.0f} ({near} near-tie rows)",
               max_gain_err=gerr)
    return out


def near_tie_rows(torch, x, med) -> int:
    """Rows of ``x`` whose two nearest rows of ``med`` lie, in fp64, within
    τ_d of each other (``hold_to_dense``): the rows whose medoid fp32
    rounding may change, each moving 1 of γ from one medoid to another."""
    rel = d2_rounding(torch, x.shape[1])
    med = med.double()
    sqm = float((med * med).sum(dim=1).max())
    near = 0
    for lo in range(0, x.shape[0], 8192):
        xb = x[lo:lo + 8192].double()
        two = torch.topk(torch.cdist(xb, med), 2, dim=1, largest=False).values
        tau = rel * ((xb * xb).sum(dim=-1) + sqm) / (2.0 * two[:, 0].clamp(min=1e-3))
        near += int(((two[:, 1] - two[:, 0]) <= tau).sum())
    return near


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

def stochastic_selection(torch, parity, card, dev, feats, y, exact) -> None:
    """Phase 10 (a): stochastic greedy on the Ijcnn1-shaped pool of phase 3
    through ``CraigSelector``, per class, seed 0.  Gates: Σγ = n; F(S) over
    F(``exact``, phase 3's device-engine selection) ≥ 1 − 1/e − δ on each
    class; a CPU run of class 1 (same engine, same seed: the same candidate
    draws) holds the card's indices under the tie rule with each step's
    sample, and its γ equal but for near-tie rows."""
    import numpy as np

    from repro_torch.core import engines as E
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.engines import stochastic

    cfg = CraigConfig(fraction=0.1, engine=E.StochasticConfig(), seed=0)
    delta = cfg.engine.delta
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = CraigSelector(cfg, device=dev).select(feats, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if st.per_class_sizes != BUDGETS or float(st.weights.sum()) != N_MAIN:
        raise AssertionError(f"stochastic: sizes {st.per_class_sizes}, Σγ {st.weights.sum()}")
    if len(np.unique(st.indices)) != st.size:
        raise AssertionError("stochastic: duplicate indices")
    ratios, m = {}, {}
    for c, n in CLASS_SIZES.items():
        pool = np.nonzero(y == c)[0]
        xc = feats[torch.as_tensor(pool, device=dev)]
        m[c] = stochastic.sample_size(n, BUDGETS[c], delta)
        d_max = float(E.pairwise_distances(xc).max()) + 1e-6
        f_st = n * d_max - coverage64(torch, xc, class_positions(np, st.indices, pool))
        f_ex = n * d_max - coverage64(torch, xc, class_positions(np, exact.indices, pool))
        ratios[c] = f_st / f_ex
        if not ratios[c] >= 1.0 - 1.0 / math.e - delta:
            raise AssertionError(f"stochastic class {c}: F ratio {ratios[c]} < 1 − 1/e − δ")
    log(f"[10] stochastic greedy (δ {delta}, m {m}) on the Ijcnn1-shaped pool: {st.size} "
        f"selected in {secs:.3f}s (phase 3's device engine: see [3]); Σγ={st.weights.sum():.0f}; "
        f"F(stochastic)/F(device engine) per class {ratios} (gate ≥ {1 - 1 / math.e - delta:.4f}); "
        f"max_memory_allocated {peak_gb:.2f} GB; {card}")

    # class 1 again on the CPU: the same candidates, drawn on the host
    pool = np.nonzero(y == 1)[0]
    x1 = feats[torch.as_tensor(pool, device=dev)]
    t0 = time.perf_counter()
    cpu = CraigSelector(dataclasses.replace(cfg, per_class=False), device="cpu").select(x1.cpu())
    cpu_s = time.perf_counter() - t0
    on_card = class_positions(np, st.indices, pool)
    w_card = st.weights[np.isin(st.indices, pool)]
    cands = stochastic.draw_candidates(0, BUDGETS[1], CLASS_SIZES[1], m[1])
    t = parity.first_divergence(x1, cpu.indices, on_card, parity.tie_tolerance(x1),
                                candidates=cands)
    if t is None:
        med = x1[torch.as_tensor(on_card, device=dev)]
        near = near_tie_rows(torch, x1, med)
        dgamma = float(np.abs(cpu.weights - w_card).sum())
        if dgamma > 2 * near:
            raise AssertionError(f"stochastic class 1: Σ|Δγ| = {dgamma} with {near} near-tie rows")
        verdict_ = f"identical indices; Σ|Δγ| {dgamma:.0f} ({near} near-tie rows)"
    else:
        ca, cb = coverage64(torch, x1, cpu.indices), coverage64(torch, x1, on_card)
        if abs(ca - cb) > 1e-3 * max(ca, cb):
            raise AssertionError(f"stochastic class 1: objectives {ca} and {cb} after a near-tie")
        verdict_ = f"near-tie divergence at {t} (tie rule), fp64 L(S) {ca:.4f} vs {cb:.4f}"
    log(f"[10] stochastic class 1 on the CPU ({cpu_s:.3f}s, the host's cores) against the "
        f"card: {verdict_}")


def lazy_selection(torch, parity, card, dev, xr, yr) -> None:
    """Phase 10 (b): lazy greedy (host heap over the float64 similarities)
    on phase 3's reduced pool, held to the matrix engine on the card."""
    from repro_torch.core import engines as E
    from repro_torch.core.craig import CraigConfig, CraigSelector

    out = {}
    for label, eng in (("lazy", E.LazyConfig()), ("matrix", E.MatrixConfig())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[label] = CraigSelector(CraigConfig(fraction=0.1, engine=eng), device=dev).select(xr, yr)
        torch.cuda.synchronize()
        out[label + "_s"] = time.perf_counter() - t0
    diverged = compare_selections(torch, parity, "lazy", out["lazy"], out["matrix"], xr, yr)
    sizes = out["lazy"].per_class_sizes
    log(f"[10] lazy greedy on the reduced pool {N_REDUCED} (classes {sizes}, host float64 "
        f"matrices of 8·n² bytes): {out['lazy_s']:.3f}s, matrix engine {out['matrix_s']:.3f}s; "
        f"{verdict(diverged)}; {card}")


class GrowingStream:
    """A corpus that grows: ``n_docs`` exposes a prefix of ``inner``,
    extended by :meth:`grow` (as the reference's
    tests/test_trainer_integration.py defines it; neither package has one)."""

    def __init__(self, inner, visible):
        self._inner = inner
        self.n_docs = int(visible)

    def batch(self, idx):
        return self._inner.batch(idx)

    def grow(self, n):
        self.n_docs = min(self._inner.n_docs, self.n_docs + int(n))


def streaming_lm_training(torch, ops, card, dev) -> dict:
    """Phase 10 (c): ``Trainer.run`` with ``streaming_ingest=True`` at
    qwen3-1.7b width on a corpus that grows, asynchronous refresh, with a
    fault plan that fails the second refresh attempt once (healed by one
    retry).  Counts are zeroed just before the run and read just after.
    Each drain extracts the new docs only (``ce_proxy``) and finalizes
    through ``fl_replay``; the last install is held to the dense finalize.
    Returns the run's launches."""
    import types

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.craig import CraigConfig
    from repro_torch.data import TokenStream
    from repro_torch.faults import FailurePolicy, FaultPlan, FaultSpec, injected
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(LM_ARCH)
    ds = GrowingStream(TokenStream(n_docs=LM_DOCS, seq_len=LM_SEQ, vocab_size=cfg.vocab_size),
                       STREAM_FIRST)
    tcfg = TrainerConfig(
        batch_size=LM_BATCH, select_every_epochs=1, refresh_mode="async",
        craig=CraigConfig(fraction=LM_FRACTION, per_class=False), streaming_ingest=True,
        refresh_failure_policy=FailurePolicy(max_retries=1, backoff_base_s=0.0),
    )
    budget = round(LM_FRACTION * STREAM_FIRST)
    plan = FaultPlan([FaultSpec("refresh.worker", "raise", on_calls=(2,))])
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tcfg, ds, adamw(warmup_cosine(3e-4, 10, LM_STEPS)),
                      lambda: init_params(cfg, gen), device=dev)
    finals, installed = [], []
    torch.cuda.synchronize()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with injected(plan):
        for _ in range(STREAM_MAX_STEPS):
            trainer.run(1)
            events = [m for m in trainer.metrics_log if m["event"] == "craig_refresh"]
            if len(events) == len(installed):
                continue
            installed.append((events[-1], trainer.sampler._indices.copy(),
                              trainer.sampler._weights.copy(), trainer._stream_cursor))
            if len(installed) == 1:  # keep each later drain's own finalize
                sel, result = trainer._stream_sel, trainer._stream_sel.result
                sel.result = lambda pool: finals.append(result(pool)) or finals[-1]
            if len(installed) == STREAM_DRAINS:
                break
            ds.grow(STREAM_GROW)
    trainer.refresher.wait()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sel.result = result

    steps = [m for m in trainer.metrics_log if m["event"] == "step"]
    losses = [m["loss"] for m in steps]
    if len(installed) != STREAM_DRAINS:
        raise AssertionError(f"streaming: {len(installed)} installs in {len(steps)} steps")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"streaming: losses {losses}")
    if [m for m in trainer.metrics_log if m["event"] == "craig_refresh_failed"]:
        raise AssertionError("streaming: a refresh failed")
    if (trainer._stream_cursor, sel.n_seen) != (LM_DOCS, LM_DOCS):
        raise AssertionError(f"streaming: cursor {trainer._stream_cursor}, n_seen {sel.n_seen}")
    pool_batches = STREAM_GROW // LM_BATCH
    if launches["ce_proxy"] != STREAM_DRAINS * pool_batches:
        raise AssertionError(f"streaming: ce_proxy launched {launches}; expected "
                             f"{pool_batches} per drain × {STREAM_DRAINS}")
    if launches["fl_replay"] < STREAM_DRAINS:
        raise AssertionError(f"streaming: fl_replay launched {launches}")
    if {launches[k] for k in ADAMW_KERNELS} != {len(steps)}:
        raise AssertionError(f"streaming: {launches} launched in {len(steps)} steps; "
                             "expected one adamw_sq_norm and one adamw_update a step")
    if plan.calls("refresh.worker") != STREAM_DRAINS + 1:
        raise AssertionError(f"streaming: refresh.worker calls {plan.calls('refresh.worker')}")
    for ev, idx, w, cursor in installed:
        if not (len(idx) == budget == len(np.unique(idx)) and idx.max() < cursor
                and abs(float(np.sum(w, dtype=np.float64)) - ev["n_live"]) < 1e-3):
            raise AssertionError(f"streaming v{ev['version']}: {len(idx)} docs (max "
                                 f"{idx.max()}, cursor {cursor}), Σγ {w.sum()}, {ev}")
    pool, doc_ids = trainer._stream_pool, trainer._stream_doc_ids
    if not pool.shape[0] == sel.n_rows == doc_ids.shape[0]:
        raise AssertionError(f"streaming: pool {tuple(pool.shape)}, n_rows {sel.n_rows}, "
                             f"doc ids {doc_ids.shape}")
    got = finals[-1]
    _, idx, w, _ = installed[-1]
    order = np.argsort(doc_ids[got.indices.cpu().numpy()])
    if not (np.array_equal(idx, doc_ids[got.indices.cpu().numpy()][order])
            and np.array_equal(w, got.weights.cpu().numpy()[order])):
        raise AssertionError("streaming: the last install is not the last drain's finalize")
    u = types.SimpleNamespace(indices=got.indices.cpu(), weights=got.weights.cpu())
    held = hold_to_dense(torch, sel, result, got, pool, u, installed[-1][0]["version"])
    per = [(ev["version"], ev["n_seen"], ev["n_live"], round(ev["extract_time_s"], 3),
            round(ev["ingest_time_s"], 3), round(1e3 * ev["finalize_time_s"], 2),
            round(ev["install_stall_s"], 3)) for ev, *_ in installed]
    step_s = statistics.median(m["time_s"] for m in steps[2:])
    log(f"[10] streaming ingest: {cfg.name} Trainer.run, streaming_ingest, refresh_mode="
        f"'async': {len(steps)} steps in {total_s:.1f}s (median {step_s:.4f} s/step); corpus "
        f"{STREAM_FIRST} → {LM_DOCS} docs by {STREAM_GROW}; loss {losses[0]:.4f} → "
        f"{losses[-1]:.4f}; {STREAM_DRAINS} drains of {STREAM_GROW} docs, budget {budget}; "
        f"refresh.worker calls {plan.calls('refresh.worker')} (call 2 failed, retried); "
        f"launches {launches}; max_memory_allocated {peak_gb:.2f} GB; {card}")
    log(f"[10] streaming per drain (version, n_seen, live rows, extract s, ingest s, finalize "
        f"ms, install stall s): {per}; last install held to the dense finalize: {held}")
    del trainer, pool, finals
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("ce_proxy", "fl_replay") + ADAMW_KERNELS}


def pool_coverage(torch, x, idx) -> float:
    """L(S) = Σ_i min_{j∈S} ‖x_i − x_j‖ over F_BLOCK-row blocks of the fp32
    products on the card, summed in fp64; F(S) = n·d_max − L(S) is the
    facility-location value ``benchmarks/bench_tree_select.py`` gates."""
    med = x[torch.as_tensor(idx, device=x.device)]
    sqm = torch.sum(med * med, dim=1)
    total = 0.0
    for lo in range(0, x.shape[0], F_BLOCK):
        xb = x[lo:lo + F_BLOCK]
        d2 = (xb @ med.T).mul_(-2.0).add_(torch.sum(xb * xb, dim=1)[:, None]).add_(sqm[None, :])
        total += float(torch.sqrt(torch.clamp(d2, min=0.0)).min(dim=1).values.double().sum())
    return total


def pool_d_max(torch, x) -> float:
    """The pool's largest pairwise distance + 1e-6, over F_BLOCK × 8·F_BLOCK
    tiles of the fp32 product on the card; a row block meets only the
    columns from its own first row on (the distance is symmetric)."""
    sq = torch.sum(x * x, dim=1)
    best = torch.zeros((), device=x.device)
    for lo in range(0, x.shape[0], F_BLOCK):
        xb, sqb = x[lo:lo + F_BLOCK], sq[lo:lo + F_BLOCK]
        for co in range(lo, x.shape[0], 8 * F_BLOCK):
            d2 = (xb @ x[co:co + 8 * F_BLOCK].T).mul_(-2.0)
            d2.add_(sqb[:, None]).add_(sq[None, co:co + 8 * F_BLOCK])
            best = torch.maximum(best, d2.max())
    return math.sqrt(max(float(best), 0.0)) + 1e-6


def hold_merge64(torch, parity, cands, got, steps: int) -> dict:
    """Hold the first ``steps`` picks of a two-round selection to an fp64
    weighted greedy over the candidate union, built here from the leaves'
    ``(feats, γ, global ids)`` in shard order.  Each pick must be a union
    member, and its fp64 gain given the picks before it within τ·max γ of
    the best (``parity``'s tie rule of a weighted greedy)."""
    cx = torch.cat([c[0] for c in cands]).double()
    cw = torch.cat([c[1] for c in cands]).double()
    pos = {g: i for i, g in enumerate(torch.cat([c[2] for c in cands]).tolist())}
    picks = [pos.get(int(g), -1) for g in got[:steps]]
    if -1 in picks:
        raise AssertionError(f"pick {picks.index(-1)} is not in the candidate union")
    dist = torch.cdist(cx, cx)
    cover = torch.full_like(cw, float(dist.max()) + 1e-6)
    chosen = torch.zeros(cx.shape[0], dtype=torch.bool, device=cx.device)
    tol = parity.tie_tolerance(cx) * float(cw.max())
    exact, worst = 0, 0.0
    for t, p in enumerate(picks):
        g = (torch.clamp(cover[:, None] - dist, min=0.0) * cw[:, None]).sum(dim=0)
        g[chosen] = float("-inf")
        best, e = torch.max(g, dim=0)
        gap = float(best) - float(g[p])
        if gap > tol:
            raise AssertionError(f"merge pick {t} ({p}) is {gap} below the fp64 best "
                                 f"{float(best)} (tol {tol})")
        exact += int(e) == p
        worst = max(worst, gap)
        chosen[p] = True
        cover = torch.minimum(cover, dist[:, p])
    return {"union": cx.shape[0], "steps": len(picks), "fp64_argmax": exact,
            "max_gap": worst, "tol": tol}


def hold_reweight64(torch, x, got, tol_d: float) -> dict:
    """γ and L(S) of a selection recomputed from the pool in fp64 on the
    card: every row to its nearest ``x[got.indices]``.  An fp32 distance
    d from the norm expansion is off by at most e = min(tol_d, tol_d²/2d)
    (``dist_tol``: the root of the d² rounding near 0, its first-order
    share away from 0).  A count may move only with a row whose two
    nearest medoids lie within 2e; L(S) may differ by Σe and a pairwise
    fp32 sum's 2·⌈log₂ n⌉·ε₃₂·L."""
    import numpy as np

    med = x[torch.as_tensor(got.indices, device=x.device)].double()
    r = med.shape[0]
    counts = torch.zeros(r, dtype=torch.float64, device=x.device)
    total, slack, near = 0.0, 0.0, 0
    for lo in range(0, x.shape[0], F_BLOCK):
        two = torch.topk(torch.cdist(x[lo:lo + F_BLOCK].double(), med), 2, dim=1,
                         largest=False)
        d1 = two.values[:, 0]
        e = torch.clamp(tol_d * tol_d / (2.0 * d1), max=tol_d)
        counts += torch.bincount(two.indices[:, 0], minlength=r).double()
        total += float(d1.sum())
        slack += float(e.sum())
        near += int((two.values[:, 1] - d1 <= 2.0 * e).sum())
    moved = float(np.abs(counts.cpu().numpy() - got.weights).sum())
    if moved > 2 * near:
        raise AssertionError(f"γ differs from the fp64 assignment by {moved} counts, "
                             f"with {near} near-tie rows")
    bound = slack + 2 * math.ceil(math.log2(x.shape[0])) * torch.finfo(torch.float32).eps * total
    if abs(got.coverage - total) > bound:
        raise AssertionError(f"L(S) {got.coverage} against fp64 {total} (bound {bound})")
    return {"moved": moved, "near_ties": near, "L64": total, "L_bound": bound}


def timed_select(torch, ops, fn):
    """Counts zeroed just before ``fn()``, read just after; host seconds
    around work that ends in a synchronize."""
    torch.cuda.synchronize()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(ops.LAUNCHES)


def hold_selection(sel, n: int, r: int, tag: str) -> None:
    import numpy as np

    wsum = float(np.sum(sel.weights, dtype=np.float64))
    if wsum != n or sel.size != r or len(np.unique(sel.indices)) != r:
        raise AssertionError(f"{tag}: Σγ {wsum} (expected {n}), {sel.size} selected "
                             f"({len(np.unique(sel.indices))} distinct), expected {r}")
    if not math.isfinite(sel.coverage):
        raise AssertionError(f"{tag}: coverage {sel.coverage}")


def launch_tree(nproc: int, args: list, victim_env: dict | None = None) -> list:
    """``python -m repro_torch.launch.tree`` in ``nproc`` processes over a
    store on a free local port; the last process gets ``victim_env``.
    Returns [(returncode, stdout, stderr)]; every process is reaped."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_FAULT_PLAN", None)
    common = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(nproc), *args]
    procs = []
    try:
        for i in range(nproc):
            e = dict(env, **victim_env) if victim_env and i == nproc - 1 else env
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.tree", "--process-id", str(i),
                 *common], env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        outs = [p.communicate(timeout=PROC_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def tree_record(out: str, err: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("TREE_SELECT_RESULT ")]
    if len(lines) != 1:
        raise AssertionError(f"launch/tree.py printed {len(lines)} results: {err[-2000:]}")
    return json.loads(lines[0].split(" ", 1)[1])


def distributed_selection(torch, ops, card, dev, feats) -> tuple:
    """Phase 11: the distributed path of slice 9 on the card.  Returns the
    launches of its kernels on its main paths, their largest errors against
    their plain twins and (b)'s seconds on each wire."""
    import numpy as np

    from repro_torch import parity
    from repro_torch.core import engines as E
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.distributed import leaf_round
    from repro_torch.core.engines.sparse import ASSIGN_BLOCK_BYTES
    from repro_torch.distributed.tree_select import (
        TreeTopology, default_r_node, tree_select_host, wire_bytes_plan)
    from repro_torch.kernels import fl_gains as kfl
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.launch.tree import _synthetic_pool

    n, d = feats.shape
    used = {k: 0 for k in ops.LAUNCHES}
    errs = {"topk_sim": 0.0, "pairwise_l2": 0.0, "fl_gains_argmax": 0.0}

    def count(launches):
        for k, v in launches.items():
            used[k] += v

    # (a) two rounds on a 4-shard mesh of the one card, and the one-level
    # fp32 tree: equal bit for bit
    mesh = compat_mesh((TREE_SHARDS,), ("data",), devices=[dev])
    sel = CraigSelector(CraigConfig(fraction=TREE_FRACTION, per_class=False,
                                    engine=E.SparseConfig()), device=dev)
    r_final = sel._budget(n)
    torch.cuda.reset_peak_memory_stats()
    two, two_s, la = timed_select(torch, ops, lambda: sel.select_distributed(feats, mesh))
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    tree, tree_s, lb = timed_select(
        torch, ops, lambda: sel.select_tree(feats, (TREE_SHARDS,), compress="none"))
    count(la)
    count(lb)
    for tag, got, launches in (("two-round", two, la), ("one-level tree", tree, lb)):
        hold_selection(got, n, r_final, f"[11a] {tag}")
        if launches["topk_sim"] != TREE_SHARDS:
            raise AssertionError(f"[11a] {tag}: launches {launches}, expected "
                                 f"{TREE_SHARDS} topk_sim (one a shard)")
    if not (np.array_equal(two.indices, tree.indices)
            and np.array_equal(two.weights, tree.weights)):
        raise AssertionError("[11a] select_distributed and select_tree((4,), 'none') differ")
    if abs(two.coverage - tree.coverage) > 1e-5 * abs(two.coverage):
        raise AssertionError(f"[11a] coverage {two.coverage} vs {tree.coverage}")
    log(f"[11a] two rounds over a {TREE_SHARDS}-shard mesh of {dev} ({n} × {d}, shards of "
        f"{n // TREE_SHARDS}, r_final {r_final}, engine {two.engine}): {two_s:.3f}s, launches "
        f"{la}; the one-level fp32 tree {tree_s:.3f}s, launches {lb}; equal indices and γ, "
        f"L(S) {two.coverage:.4f} / {tree.coverage:.4f}; Σγ "
        f"{np.sum(two.weights, dtype=np.float64):.0f}; max_memory_allocated {peak_a:.2f} GB; "
        f"{card}")

    # (a) against references built here: the leaves rerun shard by shard
    # (shard 0's topk_sim graph and first pairwise_l2 assignment block held
    # to their plain twins), the merge's first picks against an fp64
    # weighted greedy over their union, γ and L(S) against an fp64
    # assignment of the pool
    t0 = time.perf_counter()
    ec = E.engine_config_from_dict(two.engine)
    nl = n // TREE_SHARDS
    r_local = max(1, min(nl, int(r_final * 2 / TREE_SHARDS) + 1))
    cands = []
    for s in range(TREE_SHARDS):
        xs = feats[s * nl:(s + 1) * nl].contiguous()
        idx, w = leaf_round(xs, r_local, ec)
        cands.append((xs[idx], w, s * nl + idx))
        if s:
            continue
        tol_s = dist_tol(torch, xs)
        errs["topk_sim"], g_diff = compare_graphs(
            torch, xs, ops.topk_sim(xs, ec.k, impl="cuda"),
            ops.topk_sim(xs, ec.k, impl="torch"), tol_s)
        rows = min(nl, ASSIGN_BLOCK_BYTES // (4 * r_local))
        xb, med = xs[:rows].contiguous(), xs[idx].contiguous()
        errs["pairwise_l2"] = float((ops.pairwise_l2(xb, med, impl="cuda")
                                     - ops.pairwise_l2(xb, med, impl="torch")).abs().max())
        if errs["pairwise_l2"] > tol_s:
            raise AssertionError(f"[11a] pairwise_l2 at {rows} × {r_local} × {d}: max |err| "
                                 f"{errs['pairwise_l2']} > {tol_s}")
        log(f"[11a] shard 0 ({nl} × {d}): topk_sim k={ec.k} against its plain twin: max "
            f"|Δvals| {errs['topk_sim']:.3e} (tol {tol_s:.3e}), {g_diff} of {nl * ec.k} index "
            f"slots differ (near-ties); pairwise_l2 at the first assignment block ({rows} × "
            f"{r_local} × {d}) against its plain twin: max |err| {errs['pairwise_l2']:.3e}")
        del xb, med
    merge = hold_merge64(torch, parity, cands, two.indices, MERGE_STEPS)
    reweight = hold_reweight64(torch, feats, two, dist_tol(torch, feats))
    del cands
    log(f"[11a] the two rounds against references built here ({time.perf_counter() - t0:.1f}s): "
        f"the first {merge['steps']} merge picks against an fp64 weighted greedy over the "
        f"{merge['union']}-candidate union: {merge['fp64_argmax']} are its argmax, the largest "
        f"gap {merge['max_gap']:.3e} (tol {merge['tol']:.3e}); γ against the fp64 assignment of "
        f"the pool: {reweight['moved']:.0f} counts moved ({reweight['near_ties']} near-tie rows), "
        f"L(S) {two.coverage:.4f} against fp64 {reweight['L64']:.4f}")

    # (b) a deep tree with device leaves on the int8 and the fp32 wire
    deep = CraigSelector(CraigConfig(fraction=TREE_DEEP_FRACTION, per_class=False,
                                     engine=E.DeviceConfig()), device=dev)
    topo = TreeTopology(TREE_FANOUTS)
    r_deep = deep._budget(n)
    r_leaf = max(1, min(n // topo.n_leaves, int(r_deep * 2 / topo.n_leaves) + 1))
    runs = {}
    for compress in ("int8", "none"):
        got, secs, launches = timed_select(
            torch, ops, lambda: deep.select_tree(feats, TREE_FANOUTS, compress=compress))
        count(launches)
        hold_selection(got, n, r_deep, f"[11b] {compress} tree")
        if launches["fl_gains_argmax"] != topo.n_leaves * r_leaf:
            raise AssertionError(f"[11b] {compress} tree: launches {launches}, expected "
                                 f"{topo.n_leaves * r_leaf} fl_gains_argmax")
        runs[compress] = (got, secs, launches)
    t0 = time.perf_counter()
    d_max = pool_d_max(torch, feats)
    cov = {c: pool_coverage(torch, feats, runs[c][0].indices) for c in runs}
    f_int8, f_fp32 = n * d_max - cov["int8"], n * d_max - cov["none"]
    obj_s = time.perf_counter() - t0
    if f_int8 / f_fp32 < OBJ_GATE:
        raise AssertionError(f"[11b] F(int8)/F(fp32) = {f_int8 / f_fp32} < {OBJ_GATE}")
    if cov["int8"] / cov["none"] > L_GATE:
        raise AssertionError(f"[11b] L(int8)/L(fp32) = {cov['int8'] / cov['none']} > {L_GATE}")
    # leaf 0 (its rows are the first of the pool): the sweep against its
    # plain twin at the leaf shape, in the first round and in a mid-run
    # state, and its candidates' int8 payload against a plain quantizer
    from repro_torch.distributed.compression import quantize_rows_int8

    leaf = feats[:-(-n // topo.n_leaves)].contiguous()
    nleaf = leaf.shape[0]
    sq = torch.sum(leaf * leaf, dim=1)
    dm = 2.0 * torch.sqrt(sq.max()) + 1e-6
    g11 = torch.Generator(device=dev).manual_seed(11)
    states = {"first round": (torch.zeros(nleaf, device=dev),
                              torch.zeros(nleaf, dtype=torch.bool, device=dev)),
              "mid-run": (0.5 * dm * torch.rand(nleaf, device=dev, generator=g11),
                          torch.rand(nleaf, device=dev, generator=g11) < 0.3)}
    states["mid-run"][1][-1] = False
    for state, (cur, chosen) in states.items():
        e, _ = hold_argmax(torch, ops, leaf, cur, sq, dm, chosen, "float32",
                           f"[11b] fl_gains_argmax at {nleaf} × {d}, {state}")
        errs["fl_gains_argmax"] = max(errs["fl_gains_argmax"], e)
    madj = (dm - states["first round"][0]).contiguous()
    free = states["first round"][1]
    sweep_ms = median_ms(torch, lambda: kfl.fl_gains_argmax_cuda(leaf, leaf, madj, sq, sq, free))
    idx, _ = leaf_round(leaf, r_leaf, E.engine_config_from_dict(runs["int8"][0].engine["local"]))
    payload = leaf[idx]
    q, scale = quantize_rows_int8(payload)
    xf = payload.cpu().numpy()
    want_scale = np.max(np.abs(xf), axis=1) / np.float32(127.0) + np.float32(1e-12)
    want_q = np.clip(np.round(xf / want_scale[:, None]), -127, 127).astype(np.int8)
    bad_q = int(np.sum(q.cpu().numpy() != want_q))
    bad_s = int(np.sum(scale.cpu().numpy() != want_scale))
    if bad_q or bad_s:
        raise AssertionError(f"[11b] leaf 0's int8 payload: {bad_q} of {want_q.size} codes and "
                             f"{bad_s} of {want_scale.size} scales differ from a plain quantizer")
    sent = q.numel() * q.element_size() + scale.numel() * scale.element_size()
    fp32_sent = payload.numel() * payload.element_size()
    plan = wire_bytes_plan(topo, r_leaf, default_r_node(r_leaf, r_deep), d, "int8")["per_level"][0]
    if (plan["bytes"], plan["fp32_bytes"]) != (plan["children"] * sent,
                                               plan["children"] * fp32_sent):
        raise AssertionError(f"[11b] wire plan {plan} against a built payload of {sent} "
                             f"bytes ({fp32_sent} in fp32)")
    del leaf, sq, madj, free, states, payload
    for compress, (got, secs, launches) in runs.items():
        log(f"[11b] tree {TREE_FANOUTS} ({topo.n_leaves} leaves of {n // topo.n_leaves}–"
            f"{-(-n // topo.n_leaves)}, r_local {r_leaf}, r_final {r_deep}, device leaves) on "
            f"the {compress} wire: {secs:.3f}s, launches {launches}, L(S) "
            f"{got.coverage:.4f}; {card}")
    log(f"[11b] F(int8) / F(fp32) = {f_int8:.6e} / {f_fp32:.6e} = {f_int8 / f_fp32:.6f} "
        f"(gate {OBJ_GATE}); L(int8) / L(fp32) = {cov['int8']:.4f} / {cov['none']:.4f} = "
        f"{cov['int8'] / cov['none']:.6f} (gate {L_GATE}); d_max {d_max:.6f}, {obj_s:.2f}s")
    log(f"[11b] leaf 0's {r_leaf} candidates on the int8 wire: codes and scales equal a plain "
        f"true-division quantizer's; {sent:,} bytes against {fp32_sent:,} in fp32 (reduction "
        f"{fp32_sent / sent:.4f}), {topo.n_leaves} of them at level 1 as wire_bytes_plan counts")
    log(f"[11b] fl_gains_argmax at the leaf shape (n = m = {nleaf}, d = {d}, fp32) against its "
        f"plain twin, first round and mid-run: max |Δgain| {errs['fl_gains_argmax']:.3e}; alone "
        f"{sweep_ms:.3f} ms (median of {TIMED_LAUNCHES}); × {topo.n_leaves * r_leaf} rounds = "
        f"{sweep_ms * topo.n_leaves * r_leaf / 1e3:.3f} s of a run; {card}")

    # (c) the process driver: four launch/tree.py processes on the one card
    args = ["--n", str(PROC_N), "--d", str(PROC_D), "--r-local", str(PROC_R_LOCAL),
            "--r-final", str(PROC_R_FINAL), "--device", "cuda"]
    t0 = time.perf_counter()
    res = launch_tree(4, ["--fanouts", "2,2", *args])
    clean_s = time.perf_counter() - t0
    for rc, _, err in res:
        if rc != 0:
            raise AssertionError(f"[11c] launch/tree.py exited {rc}: {err[-2000:]}")
    recs = [tree_record(out, err) for _, out, err in res]
    keys = ("indices", "weights", "coverage")
    if any(tuple(r[k] for k in keys) != tuple(recs[0][k] for k in keys) for r in recs):
        raise AssertionError("[11c] the processes disagree")
    host = tree_select_host(torch.from_numpy(_synthetic_pool(PROC_N, PROC_D, 0)).to(dev),
                            TreeTopology((2, 2)), PROC_R_LOCAL, PROC_R_FINAL, compress="int8")
    if (host.indices.tolist() != recs[0]["indices"] or host.weights.tolist() != recs[0]["weights"]
            or float(host.coverage) != recs[0]["coverage"]):
        raise AssertionError("[11c] the process driver differs from tree_select_host")
    log(f"[11c] 4 launch/tree.py processes on {recs[0]['device']} (fan-outs 2,2, {PROC_N} × "
        f"{PROC_D}, r_local {PROC_R_LOCAL}, r_final {PROC_R_FINAL}, int8 wire): {clean_s:.1f}s "
        f"(process start included); all four equal tree_select_host bit for bit; Σγ "
        f"{recs[0]['weight_sum']:.0f}, wire {recs[0]['wire_bytes']:,} bytes; {card}")
    plan_json = json.dumps({"seed": 0, "specs": [{"site": "tree.publish", "kind": "kill"}]})
    t0 = time.perf_counter()
    res = launch_tree(4, ["--fanouts", "4", *args, "--min-quorum", "0.75",
                          "--level-deadline-s", "10", "--heartbeat-interval-s", "0.2",
                          "--heartbeat-grace-s", "2.0"],
                      victim_env={"REPRO_FAULT_PLAN": plan_json})
    chaos_s = time.perf_counter() - t0
    if res[3][0] != -9:
        raise AssertionError(f"[11c] the victim exited {res[3][0]}, not by SIGKILL")
    for rc, _, err in res[:3]:
        if rc != 0:
            raise AssertionError(f"[11c] a survivor exited {rc}: {err[-2000:]}")
    recs = [tree_record(out, err) for _, out, err in res[:3]]
    health = recs[0]["health"]
    if (any(r["indices"] != recs[0]["indices"] for r in recs) or health["degraded"] is not True
            or health["missing_pids"] != [3] or health["quorum"] != 0.75
            or recs[0]["weight_sum"] != 3 * PROC_N // 4):
        raise AssertionError(f"[11c] chaos run: {[r['health'] for r in recs]}, Σγ "
                             f"{recs[0]['weight_sum']}")
    log(f"[11c] chaos run (pid 3 killed at tree.publish, fan-outs 4, min quorum 0.75): "
        f"{chaos_s:.1f}s; survivors agree, health {health}, Σγ {recs[0]['weight_sum']:.0f}; "
        f"{card}")

    # (d) the data-parallel extract at qwen3-1.7b width
    from repro_torch.configs import get_config
    from repro_torch.core.extract import ProxyExtractor
    from repro_torch.data import TokenStream
    from repro_torch.models import init_params
    from repro_torch.train.train_step import make_select_step

    cfg = get_config(LM_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    ds = TokenStream(n_docs=DP_DOCS, seq_len=LM_SEQ, vocab_size=cfg.vocab_size)
    batches = DP_DOCS // LM_BATCH
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for tag, m in (("mesh", compat_mesh((TREE_SHARDS,), ("data",), devices=[dev])),
                   ("single", None)):
        ex = ProxyExtractor(make_select_step(cfg), ds, LM_BATCH, megabatch=batches, mesh=m)
        out[tag] = timed_select(torch, ops, lambda: ex.extract(params, np.arange(DP_DOCS)))
        count(out[tag][2])
        if out[tag][2]["ce_proxy"] != batches:
            raise AssertionError(f"[11d] {tag} extract: launches {out[tag][2]}, expected "
                                 f"{batches} ce_proxy")
    fm, fs = out["mesh"][0], out["single"][0]
    if fm.shape != (DP_DOCS, cfg.d_model) or not bool(torch.isfinite(fm).all()):
        raise AssertionError(f"[11d] features {tuple(fm.shape)} or non-finite")
    if not torch.equal(fm, fs):
        raise AssertionError("[11d] the mesh extract differs from the single-device extract")
    peak_d = torch.cuda.max_memory_allocated() / 1e9
    log(f"[11d] data-parallel extract of {DP_DOCS} docs ({batches} batches of {LM_BATCH} × "
        f"{LM_SEQ}) at {LM_ARCH} width over a {TREE_SHARDS}-shard mesh of {dev}: "
        f"{out['mesh'][1]:.3f}s, launches {out['mesh'][2]}; single device {out['single'][1]:.3f}s, "
        f"launches {out['single'][2]}; features equal bit for bit; max_memory_allocated "
        f"{peak_d:.2f} GB; {card}")
    dp = {"mesh_s": out["mesh"][1], "single_s": out["single"][1], "peak_gb": peak_d}
    del params, fm, fs, out
    torch.cuda.empty_cache()
    return used, errs, {c: secs for c, (_, secs, _) in runs.items()}, dp


# ---------------------------------------------------------------------------
# Phase 12: serving (prefill and KV-cache decode)
# ---------------------------------------------------------------------------


def rel_err(torch, got, want) -> float:
    """max|got − want| / max|want|: the reference's forward-against-decode
    measure (``tests/test_models_consistency.py``)."""
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-9)


def serve_params(torch, cfg, dev):
    """Seeded fp32 weights of ``cfg`` on the card, counted against the config."""
    from repro_torch.models import init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    return params, count_params(cfg, params)


def seeded_tokens(torch, cfg, dev, B: int, T: int, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, T), device=dev, generator=gen)


def input_key(cfg) -> str:
    return "tokens" if cfg.frontend == "tokens" else "embeddings"


def seeded_inputs(torch, cfg, dev, B: int, T: int, seed: int):
    """Seeded tokens (B, T), or for a stub modality frontend seeded
    standard-normal embeddings (B, T, D) in bf16 (the frontend's output)."""
    if cfg.frontend == "tokens":
        return seeded_tokens(torch, cfg, dev, B, T, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, T, cfg.d_model, device=dev, generator=gen).to(torch.bfloat16)


def grid_positions(torch, dev, B: int, text: int, rows: int, cols: int):
    """M-RoPE position ids (B, 3, T) of a prompt of ``text`` text tokens, a
    rows × cols patch grid and as many text tokens again (arXiv:2409.12191):
    text advances the three streams together; a patch keeps t at the
    grid's start and takes h and w from its row and column; the text after
    the grid resumes one past the grid's largest position."""
    head = torch.arange(text, device=dev)
    r, c = torch.meshgrid(torch.arange(rows, device=dev), torch.arange(cols, device=dev),
                          indexing="ij")
    grid = torch.stack([torch.full((rows * cols,), text, device=dev), text + r.reshape(-1),
                        text + c.reshape(-1)])
    tail = text + max(rows, cols) + torch.arange(text, device=dev)
    pos = torch.cat([head.expand(3, -1), grid, tail.expand(3, -1)], dim=1)
    return pos.expand(B, 3, -1).contiguous()


def head_logits(torch, params, hidden):
    """fp32 logits of bf16 ``hidden`` (…, D): (…, V), or (…, C, V) with
    codebook heads."""
    from repro_torch.models import COMPUTE_DTYPE, unembed_matrix

    w = unembed_matrix(params).to(COMPUTE_DTYPE)
    h = hidden.to(COMPUTE_DTYPE)
    if w.dim() == 3:
        return torch.einsum("...d,cvd->...cv", h, w).float()
    return (h @ w.T).float()


def forced_decode(torch, cfg, params, inputs, keep: int) -> tuple:
    """Teacher-force ``inputs`` (tokens (B, T) or embeddings (B, T, D))
    through ``decode_step`` from a fresh serve state of T slots; returns
    the last ``keep`` steps' logits (B, keep, [C,] V) and the ms a step
    (host clock, synchronised)."""
    from repro_torch.models import decode_step, init_serve_state

    B, T = inputs.shape[:2]
    key = input_key(cfg)
    outs = []
    with torch.inference_mode():
        state = init_serve_state(cfg, B, T, inputs.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            logits, state = decode_step(params, cfg, state, {key: inputs[:, t:t + 1]})
            if t >= T - keep:
                outs.append(logits)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / T
    if state["pos"] != T:
        raise AssertionError(f"{cfg.name}: decode state at pos {state['pos']}, expected {T}")
    return torch.stack(outs, 1), ms


def forward_logits(torch, cfg, params, inputs, keep: int):
    """``forward``'s bf16 hidden @ unembed at the last ``keep`` positions,
    fp32 (the reference's forward-against-decode reference)."""
    from repro_torch.models import forward

    with torch.inference_mode():
        hidden, _ = forward(params, cfg, {input_key(cfg): inputs})
        return head_logits(torch, params, hidden[:, -keep:])


def recorded_routes(torch, fn):
    """``fn()`` with ``models.moe.moe_route`` recording each call's expert
    ids (G, S, K), in call order."""
    from repro_torch.models import moe

    calls = []
    route = moe.moe_route

    def recording(params, cfg, x):
        out = route(params, cfg, x)
        calls.append(out[1])
        return out

    moe.moe_route = recording
    try:
        return fn(), calls
    finally:
        moe.moe_route = route


def routed_as(torch, fn, routes):
    """``fn()`` with ``models.moe.moe_route`` sending its i-th call's tokens
    to the experts ``routes[i]`` (gates renormalised over them from the
    call's own router logits); returns fn's result and each call's fp32
    router logits."""
    from repro_torch.models import moe

    logits = []
    route, it = moe.moe_route, iter(routes)

    def forced(params, cfg, x):
        logits32, _, _ = route(params, cfg, x)
        eidx = next(it)
        logits.append(logits32)
        return logits32, eidx, torch.softmax(torch.gather(logits32, -1, eidx), dim=-1)

    moe.moe_route = forced
    try:
        return fn(), logits
    finally:
        moe.moe_route = route


def hold_decode(torch, cfg, params, tokens, tol: float, tag: str) -> dict:
    """Teacher-forced decode of ``tokens`` (or embeddings) held to ``forward`` within
    ``tol`` (relative to max|ref|, every step), and ``prefill``'s last
    logits held to the decode path's last step within ``tol``.

    An MoE config runs with capacity C = S, so that the forward drops no
    token (a decode step routes each token alone and never drops), and its
    forward and prefill route each token to the experts the decode step
    chose: where the two paths' bf16 router logits straddle a near-tie at
    the K-th expert, top-k routing would send the token through other
    experts and move its logits by far more than rounding (at
    moonshot-v1-16b-a3b's width, 8 layers, 6 of 512 token-layers; the
    logits then move by 6% of their max, PERF.md).  Each such
    choice must be a near-tie of the forward's own router: its K-th logit
    minus the least logit of the decode step's experts within
    ``tol``·max|logits|."""
    from repro_torch.serve import make_prefill_step

    B, T = tokens.shape[:2]
    routes, flips = None, ""
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    (got, ms), calls = recorded_routes(torch, lambda: forced_decode(torch, cfg, params, tokens, T))
    if cfg.n_experts:
        L = cfg.n_layers
        routes = [torch.cat([calls[t * L + layer] for t in range(T)], dim=1) for layer in range(L)]

    def forward_fn():
        return forward_logits(torch, cfg, params, tokens, T)

    def prefill_fn():
        with torch.inference_mode():
            return make_prefill_step(cfg)(params, {input_key(cfg): tokens})

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: non-finite decode logits")
    if routes is None:
        want, last = forward_fn(), prefill_fn()
    else:
        want, logits = routed_as(torch, forward_fn, routes)
        last, _ = routed_as(torch, prefill_fn, routes)
        gaps = []
        for lg, chosen in zip(logits, routes):
            kth = lg.sort(dim=-1, descending=True).values[..., cfg.top_k - 1]
            least = torch.gather(lg, -1, chosen).amin(-1)
            gaps.append((kth - least) / lg.abs().amax(-1))
        gaps = torch.stack(gaps)  # (L, B, T)
        if float(gaps.max()) > tol:
            raise AssertionError(f"{tag}: a decode routing {float(gaps.max()):.3e} of max|logits| "
                                 f"from the forward's top-{cfg.top_k}, past {tol}")
        flips = (f"; {int((gaps > 0).sum())} of {gaps.numel()} token-layers routed off the "
                 f"forward's own top-{cfg.top_k} (router gaps ≤ {float(gaps.max()):.1e} of "
                 f"max|logits|); against the forward's own routing "
                 f"{rel_err(torch, got, forward_fn()):.3e}")
    err = rel_err(torch, got, want)
    if err > tol:
        raise AssertionError(f"{tag}: decode against forward, rel err {err:.3e} > {tol}{flips}")
    err_last = rel_err(torch, got[:, -1], last)
    if err_last > tol:
        raise AssertionError(f"{tag}: prefill's last logits against decode's, rel err "
                             f"{err_last:.3e} > {tol}")
    return {"err": err, "err_prefill": err_last, "forced_ms": ms, "flips": flips}


def timed_prefill(torch, cfg, params, batch: dict, reps: int = 3) -> float:
    """Median seconds of ``make_prefill_step`` on ``batch`` (host clock,
    synchronised) after one warm-up; the logits, (B, V) or (B, C, V), are
    checked finite."""
    from repro_torch.serve import make_prefill_step

    step = make_prefill_step(cfg)
    times = []
    with torch.inference_mode():
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = step(params, batch)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
    B = batch[input_key(cfg)].shape[0]
    shape = (B, cfg.padded_vocab) if cfg.n_codebooks == 1 else (B, cfg.n_codebooks,
                                                                  cfg.padded_vocab)
    if logits.shape != shape or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill: logits {tuple(logits.shape)} or non-finite")
    return statistics.median(times)


def timed_generate(torch, cfg, params, prompts, new: int, runs: int, tag: str) -> dict:
    """``greedy_generate`` ``runs`` times, equal token for token; ms a
    decode step (prompt steps included: prompt + new steps a run) and
    tokens/s through the decode path, from the last run."""
    from repro_torch.serve import greedy_generate

    B, T = prompts.shape
    outs = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, prompts, max_new=new)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        outs.append(out)
    if out.shape != (B, T + new) or not torch.equal(out[:, :T], prompts):
        raise AssertionError(f"{tag}: generated {tuple(out.shape)} or the prompt changed")
    if int(out.min()) < 0 or int(out.max()) >= cfg.padded_vocab:
        raise AssertionError(f"{tag}: token ids outside [0, {cfg.padded_vocab})")
    if any(not torch.equal(o, outs[0]) for o in outs[1:]):
        raise AssertionError(f"{tag}: greedy decoding did not repeat token for token")
    return {"gen_s": secs, "step_ms": 1e3 * secs / (T + new), "tok_s": B * (T + new) / secs,
            "sample": out[0, T:T + 8].tolist()}


def serve_cell(torch, card, dev, cfg, tag: str, prefill_bt: tuple, forced_bt: tuple,
               gen: tuple | None, runs: int, tol: float, mem_bw: float, check=None) -> None:
    """One model through the serving path: ``make_prefill_step`` timed on
    ``prefill_bt`` seeded tokens or embeddings (under M-RoPE with the image
    grid of SERVE_GRID), the teacher-forced decode of ``forced_bt`` held to
    ``forward`` within ``tol`` (``hold_decode``), and ``greedy_generate``
    of ``gen`` = (batch, prompt, new) ``runs`` times (none for a stub
    frontend); then ``check(params)``.  The decode step's floor: its fp32
    weights (all but the embedding table, of which it gathers B rows) read
    once at the card's memory rate; every weight is cast to bf16 at its
    product, which doubles the bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, n_params = serve_params(torch, cfg, dev)
    init_s = time.perf_counter() - t0
    batch = {input_key(cfg): seeded_inputs(torch, cfg, dev, *prefill_bt, 1)}
    if cfg.mrope_sections is not None:
        batch["positions"] = grid_positions(torch, dev, prefill_bt[0], *SERVE_GRID)
    prefill_s = timed_prefill(torch, cfg, params, batch)
    del batch
    held = hold_decode(torch, cfg, params, seeded_inputs(torch, cfg, dev, *forced_bt, 2),
                       tol, tag)
    table = cfg.padded_vocab * cfg.d_model if "embed" in params and "unembed" in params else 0
    floor_ms = 1e3 * 4 * (n_params - table) / mem_bw
    grid = " (image-grid positions)" if cfg.mrope_sections is not None else ""
    log(f"[12] {tag}: {cfg.name} ({cfg.n_layers} of {published_layers(cfg)} layers, "
        f"{n_params:,} params, {4 * n_params / 1e9:.1f} GB fp32, seeded in {init_s:.1f}s); "
        f"prefill {prefill_bt[0]}×{prefill_bt[1]} {input_key(cfg)}{grid} {prefill_s:.4f}s "
        f"({prefill_bt[0] * prefill_bt[1] / prefill_s:.0f} tokens/s); teacher-forced decode "
        f"{forced_bt[0]}×{forced_bt[1]}: {held['forced_ms']:.2f} ms a step, against forward "
        f"rel err {held['err']:.3e}, prefill's last logits {held['err_prefill']:.3e} (tol "
        f"{tol:.4g}){held['flips']}; floor of a step: its fp32 weights (all but the embedding "
        f"table) read once {floor_ms:.2f} ms, {2 * floor_ms:.2f} ms with the bf16 copies "
        f"written and read; {card}")
    if gen is not None:
        B, T, new = gen
        g = timed_generate(torch, cfg, params, seeded_tokens(torch, cfg, dev, B, T, 3), new,
                           runs, tag)
        log(f"[12] {tag}: greedy_generate batch {B}, prompt {T}, {new} new, {runs}× equal: "
            f"{g['gen_s']:.3f}s a run, {g['step_ms']:.2f} ms a decode step ({T + new} steps), "
            f"{g['tok_s']:.0f} tokens/s; sample {g['sample']}; {card}")
    if check is not None:
        check(params)
    log(f"[12] {tag}: max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{card}")
    del params
    torch.cuda.empty_cache()


def fp32_decode(torch, card, dev, cfg, params, tag: str) -> None:
    """Phase 12 (f), (h): the teacher-forced decode held to ``forward``
    with every product in fp32 (``COMPUTE_DTYPE`` float32 for the check),
    within FP32_DECODE_TOL[tag]: what is left is the two forms' own fp32
    difference and the bf16 KV cache's rounding, not bf16 products."""
    import repro_torch.models as M

    forced, tol = SERVE_EMB_CELLS[tag][3], FP32_DECODE_TOL[tag]
    tokens = seeded_inputs(torch, cfg, dev, *forced, 2)
    M.COMPUTE_DTYPE = M.model.COMPUTE_DTYPE = torch.float32
    try:
        got, ms = forced_decode(torch, cfg, params, tokens, forced[1])
        want = forward_logits(torch, cfg, params, tokens, forced[1])
    finally:
        M.COMPUTE_DTYPE = M.model.COMPUTE_DTYPE = torch.bfloat16
    err = rel_err(torch, got, want)
    if not bool(torch.isfinite(got).all()) or err > tol:
        raise AssertionError(f"{tag} {cfg.name}: fp32 decode against forward, rel err "
                             f"{err:.3e} > {tol}")
    log(f"[12] {tag} {cfg.name}: with fp32 products, teacher-forced decode {forced[0]}×"
        f"{forced[1]} against forward rel err {err:.3e} (tol {tol}), {ms:.2f} ms a step; "
        f"{card}")


def mrope_equals_rope(torch, card, dev, cfg, params) -> None:
    """Phase 12 (g): the whole model's hidden states under M-RoPE with three
    equal position streams against the same weights under RoPE (the
    reference's ``tests/test_attention.py`` mrope-reduces-to-rope check, at
    full width and depth): within 1e-5 of max|RoPE|."""
    from repro_torch.models import forward

    B, T = 2, LM_SEQ
    x = seeded_inputs(torch, cfg, dev, B, T, 7)
    pos = torch.arange(T, device=dev).expand(B, T)
    with torch.inference_mode():
        h3, _ = forward(params, cfg, {"embeddings": x, "positions": pos[:, None].expand(B, 3, T)})
        h1, _ = forward(params, dataclasses.replace(cfg, mrope_sections=None),
                        {"embeddings": x, "positions": pos})
    err = rel_err(torch, h3.float(), h1.float())
    if not bool(torch.isfinite(h3).all()) or err > 1e-5:
        raise AssertionError(f"{cfg.name}: M-RoPE with equal streams against RoPE, rel err "
                             f"{err:.3e} > 1e-5")
    log(f"[12] (g) {cfg.name}: M-RoPE {cfg.mrope_sections} with three equal streams against "
        f"RoPE on the same weights, hidden states {B}×{T}: rel err {err:.3e} (tol 1e-5); {card}")


def ring_wrap(torch, card, dev) -> None:
    """Phase 12 (c): recurrentgemma-9b at published width, one period
    (rglru, rglru, local_attn).  Teacher-force RING_T tokens, past the
    2,048-slot ring, and hold the last RING_KEEP steps to ``forward``;
    then ``forward`` at BLOCK_T > 2·window, which takes the blockwise
    windowed path (counted), and one local_attn layer's blockwise output
    on its own q, k, v held to ``_dense_attention`` with the same window
    (2⁻⁵·max|dense|, the port's bf16 bound)."""
    from repro_torch.configs import get_config
    from repro_torch.models import COMPUTE_DTYPE, attention as A, forward
    from repro_torch.models.blocks import attn_config, layer_params

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=3)
    if cfg.layer_kinds != ("rglru", "rglru", "local_attn") or RING_T <= cfg.window:
        raise AssertionError(f"ring cell: kinds {cfg.layer_kinds}, T {RING_T}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, n_params = serve_params(torch, cfg, dev)
    tokens = seeded_tokens(torch, cfg, dev, 1, RING_T, 4)
    got, ms = forced_decode(torch, cfg, params, tokens, RING_KEEP)
    err = rel_err(torch, got, forward_logits(torch, cfg, params, tokens, RING_KEEP))
    if err > RING_TOL:
        raise AssertionError(f"ring wrap: last {RING_KEEP} steps against forward, rel err "
                             f"{err:.3e} > {RING_TOL}")

    calls = []
    blockwise = A._blockwise_attention

    def counted(*args):
        calls.append(args[0].shape[1])
        return blockwise(*args)

    A._blockwise_attention = counted
    try:
        long = seeded_tokens(torch, cfg, dev, 1, BLOCK_T, 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            hidden, _ = forward(params, cfg, {"tokens": long})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    finally:
        A._blockwise_attention = blockwise
    if calls != [BLOCK_T] or not bool(torch.isfinite(hidden).all()):
        raise AssertionError(f"forward at T={BLOCK_T}: blockwise calls {calls}, or non-finite")
    acfg = attn_config(cfg, "local_attn")
    p = {k[len("mixer."):]: v for k, v in layer_params(params, 2).items()
         if k.startswith("mixer.")}
    with torch.inference_mode():
        x = 0.5 * torch.randn(1, BLOCK_T, cfg.d_model, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(6))
        pos = torch.arange(BLOCK_T, device=dev)[None]
        q, k, v = A._project_qkv(p, acfg, x.to(COMPUTE_DTYPE), pos)
        rep = cfg.n_heads // cfg.n_kv_heads
        k, v = A._repeat_kv(k, rep), A._repeat_kv(v, rep)
        scale = A._scale(acfg)
        block = A._blockwise_attention(q, k, v, scale, acfg)
        dense = A._dense_attention(q, k, v, scale, 0, acfg.window)
    att_err = float((block.float() - dense.float()).abs().max())
    att_tol = 2.0**-5 * float(dense.float().abs().max())
    if att_err > att_tol:
        raise AssertionError(f"blockwise windowed attention against dense: {att_err} > {att_tol}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[12] (c) ring wrap: {cfg.name} ({cfg.n_layers} of {published_layers(cfg)} layers, "
        f"{n_params:,} params) teacher-forced 1×{RING_T} tokens through a {cfg.window}-slot "
        f"ring: {ms:.2f} ms a step; last {RING_KEEP} steps against forward rel err {err:.3e} "
        f"(tol {RING_TOL}); forward at T={BLOCK_T} {fwd_s:.3f}s through the "
        f"blockwise windowed path ({len(calls)} call, chunks of {acfg.chunk_q}); one "
        f"local_attn layer blockwise against dense, max |err| {att_err:.3e} (tol "
        f"{att_tol:.3e}); max_memory_allocated {peak_gb:.2f} GB; {card}")
    del params, hidden, q, k, v, block, dense
    torch.cuda.empty_cache()


def serve_subprocesses(card) -> None:
    """Phase 12 (e): the decode launcher and the serving example, each in a
    subprocess on the card, started together (their time is process start;
    neither is timed against the other); each must exit 0."""
    runs = (["repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke", "--device", "cuda",
             "--batch", "4", "--prompt-len", "16", "--new", "32"],
            ["repro_torch.examples.serve_batched", "--window", "8", "--device", "cuda"])

    def run(argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
        return proc, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        done = list(pool.map(run, runs))
    for argv, (proc, secs) in zip(runs, done):
        if proc.returncode != 0:
            raise AssertionError(f"{argv[0]} exited {proc.returncode}: {proc.stdout[-2000:]} "
                                 f"{proc.stderr[-2000:]}")
        log(f"[12] (e) python -m {' '.join(argv)}: "
            f"{' | '.join(proc.stdout.strip().splitlines())} "
            f"({secs:.1f}s, process start included, beside the other); {card}")


def serving(torch, card, dev, mem_bw: float, real: dict | None = None) -> None:
    """Phase 12: (a) qwen3-1.7b and (b) recurrentgemma-9b at full published
    depth and width, (c) the ring wrap and the blockwise windowed path,
    (d) moonshot-v1-16b-a3b at published width with depth cut (the MoE FFN
    in decode), (e) the two serving subprocesses; slice 11's (f)
    xlstm-1.3b, (g) qwen2-vl-7b (with the M-RoPE against RoPE check) and
    (h) musicgen-medium at full published depth and width.  ``real`` maps
    a cell's tag to a further check on its model (phase 13 (b))."""
    from repro_torch.configs import get_config

    real = real or {}

    def also(tag, check=None):
        extra = real.get(tag)
        if extra is None or check is None:
            return extra or check
        return lambda *a: (check(*a), extra(*a))

    def cell(tag, check=None):
        name, layers, prefill_bt, forced_bt, gen, runs, tol = {**SERVE_CELLS,
                                                               **SERVE_EMB_CELLS}[tag]
        cfg = get_config(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.perf_counter()
        serve_cell(torch, card, dev, cfg, tag, prefill_bt, forced_bt, gen, runs, tol, mem_bw,
                   None if check is None else lambda params: check(torch, card, dev, cfg, params))
        log(f"[12] {tag}: {time.perf_counter() - t0:.1f}s")

    cell("(a)", also("(a)"))
    cell("(b)", also("(b)"))
    t0 = time.perf_counter()
    ring_wrap(torch, card, dev)
    log(f"[12] (c): {time.perf_counter() - t0:.1f}s")
    cell("(d)")
    serve_subprocesses(card)
    cell("(f)", also("(f)", lambda *a: fp32_decode(*a, "(f)")))
    cell("(g)", mrope_equals_rope)
    cell("(h)", lambda *a: fp32_decode(*a, "(h)"))


# ---------------------------------------------------------------------------
# phase 13: the dry run and the roofline
# ---------------------------------------------------------------------------


def start_dryrun_sweep() -> list:
    """Phase 13 (a), started before phase 12 (it is host work alone):
    DRYRUN_WORKERS ``launch/dryrun.py`` processes, the archs dealt round
    robin, each tracing its archs' p1 and p2 probes of every shape, then
    their full-depth decode_32k, long_500k and select_pool cells, on fake
    tensors of the card's device type.  Returns [(Popen, log path)]; each
    process leads a session of its own, so ``stop_sweep`` ends it whole."""
    import shlex

    from repro_torch.configs import ARCHS

    archs = sorted(ARCHS)
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for w in range(DRYRUN_WORKERS):
        base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                *archs[w::DRYRUN_WORKERS], "--device", "cuda", "--out", str(DRYRUN_DIR),
                "--force"]
        cmd = "; ".join(f"{shlex.join(c)} || rc=1" for c in (
            base + ["--probes-only"],
            base + ["--shape", "decode_32k", "long_500k", "select_pool"]))
        path = DRYRUN_DIR / f"sweep{w}.log"
        script = f"rc=0; time {{ {cmd}; }}; exit $rc"
        with open(path, "w") as out:
            procs.append((subprocess.Popen(
                ["bash", "-c", script], stdout=out, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), start_new_session=True),
                path))
    return procs


def stop_sweep(procs) -> None:
    import signal

    for proc, _ in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def reckon_cell(torch, cfg, shape) -> dict:
    """The dry run's reckoning of ``cfg`` at ``shape`` traced in this
    process on fake CUDA tensors, with its roofline terms."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import roofline_terms

    t0 = time.perf_counter()
    cell = dryrun.build_cell(cfg, shape)
    rec = dryrun.reckon(cell["fn"], cell["make_args"], "cuda")
    c = rec["cost"]
    terms = roofline_terms(c["flops_bf16"], c["flops_fp32"], c["bytes accessed"],
                           card=torch.cuda.get_device_name(0))
    dominant = max(terms, key=terms.get)
    return {**rec, "terms": terms, "dominant": dominant, "bound_ms": 1e3 * terms[dominant],
            "trace_s": time.perf_counter() - t0}


def tensor_bytes(tree) -> int:
    return sum(t.untyped_storage().nbytes() for t in tree.values())


def hold_reckoning(torch, card, row: dict, peak: int, rec: dict) -> dict:
    """Phase 13 (b): the measured peak against the reckoned one, within
    PEAK_TOL of it; logs the cell's ms against its roofline bound."""
    want = rec["memory"]["peak_bytes"]
    row.update(peak_gb=peak / 1e9, reckoned_gb=want / 1e9, ratio=peak / want,
               bound_ms=rec["bound_ms"], dominant=rec["dominant"], trace_s=rec["trace_s"])
    log(f"[13] (b) {row['cell']}: peak {peak / 1e9:.3f} GB against reckoned {want / 1e9:.3f} "
        f"GB (ratio {peak / want:.4f}, tol {PEAK_TOL}); {row['ms']:.2f} ms a step against "
        f"its roofline bound {rec['bound_ms']:.3f} ms ({rec['dominant']}; compute "
        f"{1e3 * rec['terms']['compute']:.3f}, memory {1e3 * rec['terms']['memory']:.3f} ms); "
        f"reckoned in {rec['trace_s']:.1f}s; {card}")
    if not abs(peak - want) <= PEAK_TOL * want:
        raise AssertionError(f"{row['cell']}: measured peak {peak} bytes is not within "
                             f"{PEAK_TOL} of the reckoned {want}")
    return row


def real_decode(torch, card, dev, cfg, params, shape_name: str, batch: int,
                start: int) -> dict:
    """Phase 13 (b): DECODE_STEPS timed serve steps (after one more) of
    ``cfg`` at ``shape_name`` with ``batch`` rows from position ``start``,
    on phase 12's weights; logits finite and (B, V) or (B, C, V)."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import init_serve_state
    from repro_torch.serve import make_serve_step

    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch)
    rec = reckon_cell(torch, cfg, shape)
    other = torch.cuda.memory_allocated() - tensor_bytes(params)
    state = init_serve_state(cfg, batch, shape.seq_len, dev)
    state["pos"] = start
    inputs = seeded_inputs(torch, cfg, dev, batch, 1, 5)
    step = make_serve_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with torch.inference_mode():
        for _ in range(DECODE_STEPS + 1):
            t0 = time.perf_counter()
            logits, state = step(params, state, {input_key(cfg): inputs})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - other
    want = (batch, cfg.n_codebooks, cfg.padded_vocab) if cfg.n_codebooks > 1 else (
        batch, cfg.padded_vocab)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} {shape_name}: logits {tuple(logits.shape)}, want "
                             f"{want}, finite {bool(torch.isfinite(logits).all())}")
    if state["pos"] != start + DECODE_STEPS + 1:
        raise AssertionError(f"{cfg.name} {shape_name}: position {state['pos']}")
    del state, logits
    torch.cuda.empty_cache()
    row = {"cell": f"{cfg.name} {shape_name} B={batch} from position {start}",
           "ms": 1e3 * statistics.median(times[1:])}
    return hold_reckoning(torch, card, row, peak, rec)


def fitting_batch(torch, cfg, shape_name: str, free: int) -> tuple[int, dict]:
    """The largest of DECODE_BATCHES whose reckoned peak fits DECODE_FILL
    of ``free`` bytes."""
    from repro_torch.configs.shapes import SHAPES

    for b in DECODE_BATCHES:
        rec = reckon_cell(torch, cfg, dataclasses.replace(SHAPES[shape_name], global_batch=b))
        if rec["memory"]["peak_bytes"] <= DECODE_FILL * free:
            return b, rec
    raise AssertionError(f"{cfg.name} {shape_name}: no batch of {DECODE_BATCHES} fits")


def real_select(torch, card, dev, cfg, params, peaks) -> dict:
    """Phase 13 (b): the qwen3-1.7b select step (``make_select_step``,
    'auto': the ``ce_proxy`` kernel) at SELECT_BT, its ``ce_proxy`` launches
    counted, its peak held to the reckoning; then the kernel at that
    (B·T, D, V) held to its plain twin, timed beside the twin and the
    einsum head (those launches not counted)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.proxy import lm_unembed_input_proxy
    from repro_torch.kernels import ce_proxy as kce, ops
    from repro_torch.models import COMPUTE_DTYPE, forward, unembed_matrix
    from repro_torch.train.train_step import make_select_step

    B, T = SELECT_BT
    rec = reckon_cell(torch, cfg, ShapeSpec("select_pool", T, B, "select"))
    batch = {"tokens": seeded_tokens(torch, cfg, dev, B, T, 6),
             "labels": seeded_tokens(torch, cfg, dev, B, T, 7)}
    step = make_select_step(cfg)
    other = torch.cuda.memory_allocated() - tensor_bytes(params) - tensor_bytes(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES["ce_proxy"] = 0
    t0 = time.perf_counter()
    feats = step(params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.LAUNCHES["ce_proxy"]
    peak = torch.cuda.max_memory_allocated() - other
    if tuple(feats.shape) != (B, cfg.d_model) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"select step: {tuple(feats.shape)}, finite "
                             f"{bool(torch.isfinite(feats).all())}")
    if launches != 1:
        raise AssertionError(f"select step launched ce_proxy {launches} times, want 1")
    del feats
    row = hold_reckoning(torch, card, {"cell": f"{cfg.name} select_pool B={B}×{T}",
                                       "ms": 1e3 * secs}, peak, rec)

    _, bf16_peak, mem_bw = peaks
    with torch.no_grad():
        hidden, _ = forward(params, cfg, batch)
    h = hidden.reshape(B * T, -1).to(COMPUTE_DTYPE)
    w = unembed_matrix(params).to(COMPUTE_DTYPE)
    y = batch["labels"].reshape(-1).to(torch.int32)
    D, V = h.shape[1], w.shape[0]
    got = kce.ce_proxy_cuda(h, w, y, cfg.vocab_size)
    plain = kce.ce_proxy_torch(h, w, y, cfg.vocab_size, torch.bfloat16)
    err = float((got - plain).abs().max())
    tol = ce_tol(w, "bfloat16")
    del got, plain
    kernel = {
        "ms": median_ms(torch, lambda: kce.ce_proxy_cuda(h, w, y, cfg.vocab_size), 5),
        "plain_ms": median_ms(torch, lambda: kce.ce_proxy_torch(
            h, w, y, cfg.vocab_size, torch.bfloat16), 3, warm=1),
        "einsum_head_ms": median_ms(torch, lambda: lm_unembed_input_proxy(
            hidden, w, batch["labels"], chunk=cfg.logit_chunk, valid_v=cfg.vocab_size,
            compute_dtype=COMPUTE_DTYPE), 3, warm=1),
        **ce_bound(B * T, D, V, 2, bf16_peak, mem_bw)}
    log(f"[13] (b) ce_proxy bf16 at ({B * T:,}, {D:,}, {V:,}): max |kernel − plain| {err:.3e} "
        f"(tol {tol:.3e}); kernel {kernel['ms']:.3f} ms, plain {kernel['plain_ms']:.3f} ms, "
        f"einsum head {kernel['einsum_head_ms']:.3f} ms, bound {kernel['bound_ms']:.3f} ms "
        f"({kernel['bound_by']}); {card}")
    if not err <= tol:
        raise AssertionError(f"ce_proxy at ({B * T}, {D}, {V}): {err} > {tol}")
    del hidden, h, w, y
    torch.cuda.empty_cache()
    return {**row, "launches": launches, "ce_err": err, "ce": kernel}


def reckoned_cells(torch, card, dev, peaks, rows: list) -> dict:
    """Phase 13 (b) as checks on phase 12's models: (a) qwen3-1.7b
    decode_32k at the largest batch the reckoning fits and the select step
    at SELECT_BT; (b) recurrentgemma-9b and (f) xlstm-1.3b long_500k (batch
    1, from LONG_FROM) and decode_32k at batch 128.  Each appends its row
    to ``rows``, with its seconds."""

    def timed(fn):
        def run(torch_, card_, dev_, cfg, params):
            t0 = time.perf_counter()
            fn(cfg, params)
            rows.append({"phase_s": time.perf_counter() - t0})
        return run

    def dense(cfg, params):
        free = (torch.cuda.get_device_properties(dev).total_memory
                - torch.cuda.memory_allocated() + tensor_bytes(params))
        b, _ = fitting_batch(torch, cfg, "decode_32k", free)
        rows.append(real_decode(torch, card, dev, cfg, params, "decode_32k", b, 32_768 - 4))
        rows.append(real_select(torch, card, dev, cfg, params, peaks))

    def subquadratic(cfg, params):
        rows.append(real_decode(torch, card, dev, cfg, params, "long_500k", 1, LONG_FROM))
        rows.append(real_decode(torch, card, dev, cfg, params, "decode_32k", 128, 32_768 - 4))

    return {"(a)": timed(dense), "(b)": timed(subquadratic), "(f)": timed(subquadratic)}


def dryrun_report(torch, card, procs, rows: list) -> dict:
    """Phase 13 (a)'s report: waits for the sweep, then every arch × shape
    cell's reckoned GB, ``fits``, dominant term and bound from
    ``roofline.analyze_all``; raises unless every probe traced (or skipped
    as the reference skips: long_500k for a full-attention arch) and every
    full-depth cell the sweep asked for did."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.roofline import analyze_all

    for proc, path in procs:
        rc = proc.wait(timeout=900)
        tail = path.read_text().strip().splitlines()
        log(f"[13] (a) sweep {path.name}: rc {rc}; {' | '.join(tail[-3:])}")
        if rc != 0:
            raise AssertionError(f"dry-run sweep {path} exited {rc}: {' | '.join(tail[-8:])}")
    shapes = list(SHAPES) + ["select_pool"]
    walls, missing = [], []
    for arch in sorted(ARCHS):
        for shape in shapes:
            probes = (1, 2, 0) if shape in ("decode_32k", "long_500k", "select_pool") else (1, 2)
            for probe in probes:
                path = DRYRUN_DIR / (f"{arch}__{shape}__h100x1" + (f"__p{probe}" if probe
                                                                      else "") + ".json")
                rec = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
                skip = shape == "long_500k" and not get_config(arch).is_subquadratic
                if rec["status"] != ("skip" if skip else "ok"):
                    missing.append((arch, shape, probe, rec["status"]))
                walls.append(rec.get("wall_s", 0.0))
    if missing:
        raise AssertionError(f"dry-run cells not reckoned: {missing}")
    cells = analyze_all(str(DRYRUN_DIR))
    for c in cells:
        log(f"[13] (a) {c.arch} {c.shape} ({c.step}): {c.mem_gb:.1f} GiB, "
            f"{'fits' if c.fits_hbm else 'does not fit'}; dominant {c.dominant}; bound "
            f"{1e3 * c.t_dominant:.3f} ms (compute {1e3 * c.t_compute:.3f}, memory "
            f"{1e3 * c.t_memory:.3f}); useful {c.useful_ratio:.3f}, MFU bound "
            f"{c.mfu_bound:.3f}; {'probes' if c.extrapolated else 'full depth'}")
    log(f"[13] (a) {len(cells)} cells reckoned, {len(walls)} artifacts traced in "
        f"{sum(walls):.1f}s of host time; {card}")
    real = [r for r in rows if "cell" in r]
    return {"cells": len(cells), "real_s": sum(r.get("phase_s", 0.0) for r in rows),
            "launches": sum(r.get("launches", 0) for r in real),
            "ce_err": max([r["ce_err"] for r in real if "ce_err" in r] or [0.0])}


def start_mesh_sweep() -> list:
    """Phase 14 (a), started before phase 11: MESH_WORKERS ``launch/dryrun.py
    --mesh`` processes (archs dealt round robin) tracing MESH_CELLS' p1 and
    p2 probes per device under a fake 256- or 512-rank group, on fake
    tensors of the card's device type.  Returns [(Popen, log path)]."""
    import shlex

    from repro_torch.configs import ARCHS

    archs = sorted(ARCHS)
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for w in range(MESH_WORKERS):
        runs = [["--mesh", "single", "--arch", *archs[w::MESH_WORKERS],
                 "--shape", *MESH_CELLS["single"]]]
        multi = MESH_MULTI_ARCHS[w::MESH_WORKERS]
        if multi:
            runs.append(["--mesh", "multi", "--arch", *multi, "--shape", *MESH_CELLS["multi"]])
        base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cuda",
                "--out", str(DRYRUN_DIR), "--force", "--probes-only"]
        cmd = "; ".join(f"{shlex.join(base + r)} || rc=1" for r in runs)
        path = DRYRUN_DIR / f"mesh{w}.log"
        script = f"rc=0; time {{ {cmd}; }}; exit $rc"
        with open(path, "w") as out:
            procs.append((subprocess.Popen(
                ["bash", "-c", script], stdout=out, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), start_new_session=True),
                path))
    return procs


def placed_elements(cfg, mesh_kind: str) -> int:
    """Per-device parameter elements of ``cfg`` under ``param_specs`` on a
    production mesh, from the shapes and the mesh's sizes alone."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import PRODUCTION_MESHES
    from repro_torch.models import param_shapes

    shape, names = PRODUCTION_MESHES[mesh_kind]
    sizes = dict(zip(names, shape))
    stand_in = dataclasses.make_dataclass("StandIn", ["axis_names", "shape"])(names, sizes)
    shapes = param_shapes(cfg)
    total = 0
    for k, spec in shd.param_specs(shapes, stand_in).items():
        n = math.prod(shapes[k])
        for a in spec:
            for g in (a if isinstance(a, tuple) else (a,) if a else ()):
                n //= sizes[g]
        total += n
    return total


def mesh_report(torch, card, procs) -> dict:
    """Phase 14 (a)'s report: waits for the mesh sweep, then per cell the
    per-device argument and peak bytes, collective bytes by kind and the
    roofline's three terms (``roofline.analyze_cell``, the probes
    extrapolated); raises unless every cell traced, each train cell's
    parameter and optimizer bytes (the full depth's, as placed) are 12
    bytes a MESH_PARAMS element within STATE_TOL (and the placement
    arithmetic's exactly), and every 16×16 train cell has a collective
    term."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.roofline import MESH_TAGS, analyze_cell

    for proc, path in procs:
        rc = proc.wait(timeout=900)
        tail = path.read_text().strip().splitlines()
        log(f"[14] (a) sweep {path.name}: rc {rc}; {' | '.join(tail[-3:])}")
        if rc != 0:
            raise AssertionError(f"mesh sweep {path} exited {rc}: {' | '.join(tail[-8:])}")
    walls, problems, cells = [], [], 0
    for mesh_kind, shapes in MESH_CELLS.items():
        tag = MESH_TAGS[mesh_kind]
        for arch in (sorted(ARCHS) if mesh_kind == "single" else MESH_MULTI_ARCHS):
            cfg = get_config(arch)
            for shape in shapes:
                recs = []
                for probe in (1, 2):
                    path = DRYRUN_DIR / f"{arch}__{shape}__{tag}__p{probe}.json"
                    rec = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
                    if rec["status"] != "ok":
                        problems.append((arch, shape, tag, probe, rec["status"],
                                         rec.get("error", "")[:200]))
                        continue
                    walls.append(rec["wall_s"])
                    recs.append(rec)
                if len(recs) < 2:
                    continue
                c = analyze_cell(str(DRYRUN_DIR), arch, shape, mesh_kind)
                periods = cfg.n_layers / len(cfg.block_pattern)
                kinds = {k: recs[0]["collectives"].get(k, {"bytes": 0})["bytes"]
                         + (periods - 1) * (recs[1]["collectives"].get(k, {"bytes": 0})["bytes"]
                                            - recs[0]["collectives"].get(k, {"bytes": 0})["bytes"])
                         for k in sorted(set(recs[0]["collectives"]) | set(recs[1]["collectives"]))}
                mem = recs[0]["memory"]
                state = mem["full_depth_state_size_in_bytes"]
                log(f"[14] (a) {arch} {shape} {tag} ({c.step}): per device p1 arguments "
                    f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, peak "
                    f"{mem['peak_bytes'] / 1e9:.3f} GB; full depth {c.mem_gb:.2f} GiB "
                    f"({'fits' if c.fits_hbm else 'does not fit'}), state {state / 1e9:.3f} GB; "
                    f"collective GB {' '.join(f'{k} {v / 1e9:.3f}' for k, v in kinds.items())}; "
                    f"compute {1e3 * c.t_compute:.3f} ms, memory {1e3 * c.t_memory:.3f} ms, "
                    f"collective {1e3 * c.t_collective:.3f} ms: {c.dominant}")
                cells += 1
                if shape == "train_4k":
                    placed = 12 * placed_elements(cfg, mesh_kind)
                    if state != placed:
                        problems.append((arch, shape, tag, "state", state, placed))
                    if arch in MESH_PARAMS:
                        want = 12 * MESH_PARAMS[arch]
                        log(f"[14] (a) {arch} {tag} parameter and optimizer bytes "
                            f"{state / 1e9:.4f} GB against {want / 1e9:.4f} GB: "
                            f"{state / want - 1:+.4%}")
                        if abs(state / want - 1) > STATE_TOL:
                            problems.append((arch, shape, tag, "table", state, want))
                    if mesh_kind == "single" and not c.t_collective > 0:
                        problems.append((arch, shape, tag, "no collective term"))
    if problems:
        raise AssertionError(f"phase 14 (a): {problems}")
    log(f"[14] (a) {cells} mesh cells, {len(walls)} artifacts traced in {sum(walls):.1f}s of "
        f"host time; {card}")
    return {"cells": cells}


def world_one(torch, ops, card, dev) -> dict:
    """Phase 14 (b): a real (1, 1) ("data", "model") DeviceMesh over NCCL
    in a group of one, qwen3-1.7b at full width and depth.  The train step
    (AdamW), the select step (its ``ce_proxy`` launches counted, the kernel
    held to its plain twin) and MESH_DECODE_STEPS decode steps on a
    ``serve_state_specs`` cache run on DTensors and are held to the same
    steps without a mesh on the same inputs; s a step and peak bytes of
    both are printed.  The group is destroyed at the end."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ce_proxy as kce
    from repro_torch.models import init_serve_state
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train.train_step import make_select_step, make_train_step

    cfg = get_config(LM_ARCH)
    B, T = MESH_BT
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))

        def place(tree, specs):
            return {k: distribute_tensor(v, mesh, shd.to_placements(specs[k], mesh),
                                         src_data_rank=None) for k, v in tree.items()}

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        batch = {"tokens": seeded_tokens(torch, cfg, dev, B, T, 11).to(torch.int32),
                 "labels": seeded_tokens(torch, cfg, dev, B, T, 12).to(torch.int32),
                 "weights": torch.rand(B, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(13))
                 + 0.5}
        out: dict = {}

        def timed(fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

        # the train step, unsharded and on the mesh, each from the same seeded
        # weights after a warm-up step of its own (cuBLAS handles, the
        # allocator; on the mesh, sharding propagation's caches)
        opt = adamw(warmup_cosine(3e-4, 2, 100))
        step = make_train_step(cfg, opt)
        db = place(batch, shd.batch_specs(mesh, batch))

        def fresh(placed: bool):
            params, _ = serve_params(torch, cfg, dev)
            if placed:
                params = place(params, shd.param_specs(params, mesh))
            return params, opt.init(params)

        ran = {}
        for placed in (False, True):
            b = db if placed else batch
            params, state = fresh(placed)
            step(params, state, b)
            del params, state
            torch.cuda.empty_cache()
            params, state = fresh(placed)
            (p, _, m), secs, peak = timed(lambda: step(params, state, b))
            ran[placed] = (float(full(m["loss"])), secs, peak)
            if not placed:
                host = {k: v.cpu() for k, v in p.items()}
            else:
                p1 = p
            del params, state, p, m
            torch.cuda.empty_cache()
        (loss0, s0, peak0), (loss1, s1, peak1) = ran[False], ran[True]
        differ = [k for k in host if not torch.equal(full(p1[k]).cpu(), host[k])]
        worst = max([float((full(p1[k]).cpu() - host[k]).abs().max()
                           / (host[k].abs().max() + 1e-30)) for k in differ] or [0.0])
        log(f"[14] (b) train step on (1, 1) over NCCL: loss {loss1:.6f} against {loss0:.6f} "
            f"unsharded; {len(host) - len(differ)}/{len(host)} parameters bit for bit"
            f"{'' if not differ else f', worst rel {worst:.3e} at {differ[:3]}'}; "
            f"{s1:.3f} s and {peak1 / 1e9:.2f} GB a step against {s0:.3f} s and "
            f"{peak0 / 1e9:.2f} GB unsharded; {card}")
        if differ and (worst > WORLD_ONE_TOL or abs(loss1 - loss0) > WORLD_ONE_TOL * abs(loss0)):
            raise AssertionError(f"(1, 1) train step off the unsharded one: {differ[:5]}, "
                                 f"{worst}, loss {loss1} vs {loss0}")
        out["train"] = {"bitwise": not differ and loss1 == loss0, "s": s1, "s_plain": s0,
                        "peak": peak1, "peak_plain": peak0}
        del p1, host
        torch.cuda.empty_cache()

        # the select step and decode share one set of weights (no update)
        params, _ = serve_params(torch, cfg, dev)
        dp = {k: DTensor.from_local(v, mesh, shd.to_placements(s, mesh), run_check=False)
              for (k, v), s in zip(params.items(), shd.param_specs(params, mesh).values())}
        sbatch = {k: batch[k] for k in ("tokens", "labels")}
        sdb = place(sbatch, shd.batch_specs(mesh, sbatch))
        select = make_select_step(cfg)
        select(params, sbatch)  # warm-ups
        select(dp, sdb)
        f0, t_plain, pk_plain = timed(lambda: select(params, sbatch))
        ops.LAUNCHES["ce_proxy"] = 0
        f1, t_mesh, pk_mesh = timed(lambda: select(dp, sdb))
        launches = ops.LAUNCHES["ce_proxy"]
        f1 = full(f1)
        if launches != 1:
            raise AssertionError(f"(1, 1) select step launched ce_proxy {launches} times")
        sel_bitwise = torch.equal(f1, f0)
        sel_err = rel_err(torch, f1, f0)
        # the kernel on this step's operands against its plain twin
        from repro_torch.models import COMPUTE_DTYPE, forward, unembed_matrix

        with torch.no_grad():
            hidden, _ = forward(params, cfg, sbatch)
        h = hidden.reshape(B * T, -1).to(COMPUTE_DTYPE)
        w = unembed_matrix(params).to(COMPUTE_DTYPE)
        y = sbatch["labels"].reshape(-1)
        ce_err = float((kce.ce_proxy_cuda(h, w, y, cfg.vocab_size)
                        - kce.ce_proxy_torch(h, w, y, cfg.vocab_size, torch.bfloat16)
                        ).abs().max())
        tol = ce_tol(w, "bfloat16")
        del hidden, h, w
        log(f"[14] (b) select step on (1, 1): {'bit for bit' if sel_bitwise else f'rel {sel_err:.3e}'}"
            f" the unsharded one; {launches} ce_proxy launch (max |kernel − plain| {ce_err:.3e}, "
            f"tol {tol:.3e}); {t_mesh:.3f} s and {pk_mesh / 1e9:.2f} GB against {t_plain:.3f} s "
            f"and {pk_plain / 1e9:.2f} GB unsharded")
        if not sel_bitwise and sel_err > WORLD_ONE_TOL:
            raise AssertionError(f"(1, 1) select step off the unsharded one: {sel_err}")
        if not ce_err <= tol:
            raise AssertionError(f"ce_proxy on the (1, 1) select operands: {ce_err} > {tol}")

        # decode on a serve_state_specs cache
        serve = make_serve_step(cfg)
        sp = {k: DTensor.from_local(v, mesh, shd.to_placements(s, mesh), run_check=False)
              for (k, v), s in zip(params.items(), shd.serve_param_specs(params, mesh).values())}
        st0 = init_serve_state(cfg, B, T, dev)
        st1 = init_serve_state(cfg, B, T, dev, mesh=mesh)
        dec_bitwise, dec_err, times = True, 0.0, {"mesh": [], "plain": []}
        for t in range(MESH_DECODE_STEPS):
            tok = {"tokens": sbatch["tokens"][:, t:t + 1]}
            (l0, st0), a, _ = timed(lambda: serve(params, st0, tok))
            (l1, st1), b, _ = timed(lambda: serve(sp, st1, place(tok, shd.batch_specs(mesh, tok))))
            times["plain"].append(a)
            times["mesh"].append(b)
            l1 = full(l1)
            dec_bitwise &= torch.equal(l1, l0)
            dec_err = max(dec_err, rel_err(torch, l1, l0))
        ms = {k: 1e3 * statistics.median(v[1:]) for k, v in times.items()}
        log(f"[14] (b) decode on a serve_state_specs cache (1, 1), {MESH_DECODE_STEPS} steps: "
            f"{'bit for bit' if dec_bitwise else f'rel {dec_err:.3e}'} the unsharded ones; "
            f"{ms['mesh']:.2f} ms a step against {ms['plain']:.2f} ms unsharded")
        if not dec_bitwise and dec_err > WORLD_ONE_TOL:
            raise AssertionError(f"(1, 1) decode off the unsharded one: {dec_err}")
        out.update(select={"bitwise": sel_bitwise, "s": t_mesh, "s_plain": t_plain},
                   decode={"bitwise": dec_bitwise, "ms": ms}, launches=launches, ce_err=ce_err)
        del params, dp, sp, st0, st1
        torch.cuda.empty_cache()
        return out
    finally:
        dist.destroy_process_group()


def count_syncs(torch, fn):
    """(synchronizing CUDA calls ``fn()`` makes, by the Python line that
    made each; its result; seconds): the calls are those
    ``torch.cuda.set_sync_debug_mode("warn")`` warns of."""
    import warnings
    from collections import Counter

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in seen
                    if "synchroniz" in str(w.message))
    return sites, out, time.perf_counter() - t0


def static_analysis(torch, card: str, dev) -> None:
    """Phase 15: (a) the port's repro-lint over ``src/repro_torch`` with no
    active finding; (b) the ``LAUNCHES`` keys that the contract pass finds
    launching wrappers bump, equal to ``_build.LAUNCHES`` and the report's
    kernels; (c) the host-sync pass held to the card's sync counts."""
    from collections import Counter

    from repro_torch.analysis import FileIndex, run_analysis
    from repro_torch.analysis.rules import cuda_contract
    from repro_torch.core import engines as E
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    tree = ROOT / "src" / "repro_torch"
    result = run_analysis([str(tree)])
    counts = dict(Counter(f.rule_id for f in result.findings))
    sites = [f"{f.path}:{f.line} [{f.rule_id}]" for f in result.suppressed]
    if result.active:
        raise AssertionError("repro-lint findings:\n" + "\n".join(
            f.format() for f in result.active))
    index = FileIndex.build([str(tree)])
    log(f"[15] (a) repro_torch.analysis over {len(index.modules)} files of "
        f"src/repro_torch: 0 active findings; by rule {counts}, suppressed {sites}; "
        f"{time.perf_counter() - t0:.2f}s; {card}")

    [contract] = cuda_contract.read_contracts(index)
    bumps = contract.bumped_keys()
    bumped = set().union(*bumps.values())
    if not (bumped == set(_build.LAUNCHES) == set(REPLACES)) or contract.findings:
        raise AssertionError(f"launching wrappers bump {sorted(bumped)}; LAUNCHES "
                             f"{sorted(_build.LAUNCHES)}; kernels line {sorted(REPLACES)}")
    log(f"[15] (b) {len(contract.signatures)} SIGNATURES entries matched to their "
        f"extern \"C\" prototypes; {len(contract.launching)} launching entries in "
        f"{len(bumps)} wrappers bump {sorted(bumped)} = LAUNCHES = the kernels line")

    # (c) (a) left no active in-loop sync, so each engine makes as many
    # syncs at every budget; the suppressed ones are the documented
    # exceptions (device's lazy-round commit test, q > 1 only), printed
    exceptions = {
        cls: [f"{f.path}:{f.line}" for f in result.suppressed
              if f.rule_id == "host-sync" and f"{cls}.select" in f.message]
        for cls in ("FeaturesEngine", "DeviceEngine")
    }
    log(f"[15] (c) host-sync's suppressed in-loop syncs by engine: {exceptions}")
    gen = torch.Generator(device=dev).manual_seed(15)
    pool = torch.randn(*SYNC_POOL, device=dev, generator=gen)
    runs = {  # label: (gated, engine)
        "features": (True, lambda: E.FeaturesEngine(E.FeaturesConfig())),
        "device q=1": (True, lambda: E.DeviceEngine(E.DeviceConfig(q=1))),
        "device q=16": (False, lambda: E.DeviceEngine(E.DeviceConfig(q=16))),
    }
    for label, (gated, make) in runs.items():
        # warm, under the debug mode too: the first call in a process made
        # one more sync, in torch.cuda's own __init__.py, none after it
        warm, _, _ = count_syncs(torch, lambda: make().select(pool, SYNC_BUDGETS[0]))
        seen = {}
        for budget in SYNC_BUDGETS:
            sites, res, secs = count_syncs(torch, lambda: make().select(pool, budget))
            if res.indices.shape != (budget,):
                raise AssertionError(f"{label}: {tuple(res.indices.shape)} picks")
            seen[budget] = (sum(sites.values()), secs, dict(sites))
        text = ", ".join(f"budget {b}: {n} syncs in {s * 1e3:.1f} ms at {where}"
                         for b, (n, s, where) in seen.items())
        if gated and len({n for n, _, _ in seen.values()}) != 1:
            raise AssertionError(f"{label}: the sync count grows with the budget "
                                 f"({text}) where host-sync finds no in-loop sync")
        log(f"[15] (c) {label} on {SYNC_POOL[0]:,} × {SYNC_POOL[1]} (warm run: "
            f"{dict(warm)}): {text}"
            f"{'; equal, as host-sync predicts' if gated else ' (not gated)'}; {card}")
    secs = time.perf_counter() - t0
    if secs > STATIC_LIMIT_S:
        raise AssertionError(f"phase 15 took {secs:.1f}s > {STATIC_LIMIT_S}s")
    log(f"[15] phase total {secs:.1f}s; {card}")


# ---------------------------------------------------------------------------
# Phase 16: tree selection over a group of ranks
# ---------------------------------------------------------------------------


def hold_tree_records(tag: str, res: list, host) -> dict:
    """Every ``launch/tree.py`` process exited 0 and printed the same
    selection, bit for bit ``host``'s; returns rank 0's record."""
    for rc, _, err in res:
        if rc != 0:
            raise AssertionError(f"{tag} launch/tree.py exited {rc}: {err[-2000:]}")
    recs = [tree_record(out, err) for _, out, err in res]
    for r in recs:
        if (r["driver"] != "mesh" or r["indices"] != host.indices.tolist()
                or r["weights"] != host.weights.tolist()
                or r["coverage"] != float(host.coverage)):
            raise AssertionError(f"{tag} process {r['process']} on {r['device']} differs from "
                                 "tree_select_host")
    return recs[0]


def extract_over_ranks(torch, ops, card, dev, dp_11d: dict) -> dict:
    """Phase 16 (c), in (a)'s NCCL group of one: ``ProxyExtractor`` over a
    one-axis ``DeviceMesh`` at phase 11 (d)'s cell, held bit for bit to the
    single-device extract, its ``ce_proxy`` launches and
    ``all_gather_into_tensor`` calls counted; then its features through
    ``CraigSelector.select_distributed`` over the same mesh, held bit for
    bit to the same call over a one-shard ``compat_mesh`` of the card.
    Returns the rank extract's kernel launches."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.core.extract import ProxyExtractor
    from repro_torch.data import TokenStream
    from repro_torch.distributed.tree_select import collectives_plan
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.models import init_params
    from repro_torch.train.train_step import make_select_step

    t_part = time.perf_counter()
    cfg = get_config(LM_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    ds = TokenStream(n_docs=DP_DOCS, seq_len=LM_SEQ, vocab_size=cfg.vocab_size)
    batches, pool = DP_DOCS // LM_BATCH, np.arange(DP_DOCS)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    ex = ProxyExtractor(make_select_step(cfg), ds, LM_BATCH, megabatch=batches, mesh=mesh)
    gather, calls = dist.all_gather_into_tensor, []

    def counted(out, inp, *args, **kwargs):
        calls.append((str(inp.dtype), tuple(inp.shape), str(inp.device)))
        return gather(out, inp, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    dist.all_gather_into_tensor = counted
    try:
        fr, ranked_s, launches = timed_select(torch, ops, lambda: ex.extract(params, pool))
    finally:
        dist.all_gather_into_tensor = gather
    peak = torch.cuda.max_memory_allocated() / 1e9
    single = ProxyExtractor(make_select_step(cfg), ds, LM_BATCH, megabatch=batches)
    fs, single_s, single_launches = timed_select(torch, ops,
                                                 lambda: single.extract(params, pool))
    if launches["ce_proxy"] != batches or single_launches["ce_proxy"] != batches:
        raise AssertionError(f"[16c] launches {launches} (rank extract), {single_launches} "
                             f"(single device), expected {batches} ce_proxy each")
    dispatches = len(ex._plan(DP_DOCS))
    if len(calls) != dispatches or any(dv != str(fr.device) for _, _, dv in calls):
        raise AssertionError(f"[16c] {len(calls)} all_gather_into_tensor calls {calls}, "
                             f"expected one a dispatch ({dispatches}) on {fr.device}")
    if fr.shape != (DP_DOCS, cfg.d_model) or not bool(torch.isfinite(fr).all()):
        raise AssertionError(f"[16c] features {tuple(fr.shape)} or non-finite")
    if not torch.equal(fr, fs):
        raise AssertionError("[16c] the rank extract differs from the single-device extract")
    n_gathers = len(calls)
    # again, now that both ran once (a run of this phase alone makes the
    # process's first forward of the model in the first)
    again, warm_s, _ = timed_select(torch, ops, lambda: ex.extract(params, pool))
    if not torch.equal(again, fs):
        raise AssertionError("[16c] a second rank extract differs from the first")
    del params, fs, again

    # the refresh's two rounds over the same group
    selector = CraigSelector(CraigConfig(fraction=LM_FRACTION, per_class=False), device=dev)
    calls.clear()
    dist.all_gather_into_tensor = counted
    try:
        got, sel_s, _ = timed_select(torch, ops, lambda: selector.select_distributed(fr, mesh))
    finally:
        dist.all_gather_into_tensor = gather
    want, one_s, _ = timed_select(torch, ops, lambda: selector.select_distributed(
        fr, compat_mesh((1,), ("data",), devices=[dev])))
    if not (np.array_equal(got.indices, want.indices)
            and np.array_equal(got.weights, want.weights) and got.coverage == want.coverage):
        raise AssertionError("[16c] select_distributed over the DeviceMesh differs from the "
                             "one-shard compat_mesh")
    hold_selection(got, DP_DOCS, selector._budget(DP_DOCS), "[16c]")
    if len(calls) != collectives_plan(1, "none"):
        raise AssertionError(f"[16c] two rounds: {len(calls)} all_gather_into_tensor calls "
                             f"{calls}, planned {collectives_plan(1, 'none')}")
    log(f"[16c] ProxyExtractor over a DeviceMesh ('data',) = (1,) of one NCCL rank, "
        f"{DP_DOCS} docs ({batches} batches of {LM_BATCH} × {LM_SEQ}, {dispatches} dispatch) at "
        f"{LM_ARCH} width, {cfg.n_layers} layers: {ranked_s:.3f}s (again: {warm_s:.3f}s), "
        f"launches {launches}, "
        f"{n_gathers} all_gather_into_tensor; bit for bit the single-device "
        f"extract ({single_s:.3f}s); max_memory_allocated {peak:.2f} GB; phase 11 (d): "
        f"{TREE_SHARDS}-shard Mesh {dp_11d['mesh_s']:.3f}s, single {dp_11d['single_s']:.3f}s, "
        f"{dp_11d['peak_gb']:.2f} GB; select_distributed over the same mesh: {sel_s:.3f}s, "
        f"{len(calls)} all_gather_into_tensor, {got.size} selected, Σγ "
        f"{float(np.sum(got.weights, dtype=np.float64)):.0f}, L(S) {got.coverage:.4f}, engine "
        f"{got.engine}; bit for bit the one-shard compat_mesh ({one_s:.3f}s); part "
        f"{time.perf_counter() - t_part:.1f}s; {card}")
    del fr
    torch.cuda.empty_cache()
    return launches


def tree_over_ranks(torch, ops, card, dev, host_11b: dict, dp_11d: dict) -> dict:
    """Phase 16: ``tree_select_mesh`` over the ``DeviceMesh`` of
    ``make_tree_mesh``, in process over NCCL in a group of one (a); in the
    same group the rank extract and the two rounds over it (c,
    :func:`extract_over_ranks`); ``launch/tree.py --driver mesh --device
    cuda`` (b).  Returns the kernel launches of (a) and (c)."""
    import socket

    import torch.distributed as dist

    from repro_torch.core import engines as E
    from repro_torch.core.craig import CraigConfig, CraigSelector
    from repro_torch.distributed.tree_select import (
        TreeTopology, collectives_plan, split_levels, tree_select_host, tree_select_mesh)
    from repro_torch.launch.tree import _synthetic_pool, make_tree_mesh

    t_phase = time.perf_counter()
    topo = TreeTopology(MESH_TREE_FANOUTS)
    feats, _ = covtype_pool(dev)
    n_full = feats.shape[0]
    x = feats[:MESH_TREE_N].contiguous()
    del feats
    # phase 11 (b)'s budgets: its selector's r_final on the whole pool and
    # r_local over its 32 leaves
    r_final = CraigSelector(CraigConfig(fraction=TREE_DEEP_FRACTION, per_class=False,
                                        engine=E.DeviceConfig()), device=dev)._budget(n_full)
    r_local = max(1, min(n_full // topo.n_leaves, int(r_final * 2 / topo.n_leaves) + 1))
    kw = dict(local_engine=E.DeviceConfig(), compress="int8")

    # (a) in process: NCCL in a group of one
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev.index or 0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    gather, calls = dist.all_gather_into_tensor, []

    def counted(out, inp, *args, **kwargs):
        calls.append((str(inp.dtype), tuple(inp.shape), str(inp.device)))
        return gather(out, inp, *args, **kwargs)

    try:
        mesh = make_tree_mesh(topo.fanouts, device_type="cuda")
        # NCCL makes its communicators at a group's first collective: the
        # barrier puts that in the set-up, as a user's group pays it once
        dist.barrier()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        k, axes = split_levels(topo.fanouts, 1)
        plan = collectives_plan(len(axes), "int8")
        dist.all_gather_into_tensor = counted
        try:
            got, mesh_s, launches = timed_select(
                torch, ops, lambda: tree_select_mesh(x, mesh, topo, r_local, r_final, **kw))
        finally:
            dist.all_gather_into_tensor = gather
        host, host_s, _ = timed_select(
            torch, ops, lambda: tree_select_host(x, topo, r_local, r_final, **kw))
        if not (torch.equal(got.indices, host.indices) and torch.equal(got.weights, host.weights)
                and torch.equal(got.coverage, host.coverage)):
            raise AssertionError("[16a] tree_select_mesh over NCCL differs from tree_select_host")
        if (float(got.weights.sum()) != MESH_TREE_N or len(torch.unique(got.indices)) != r_final
                or not bool(torch.isfinite(got.coverage))):
            raise AssertionError(f"[16a] Σγ {float(got.weights.sum())} (expected {MESH_TREE_N}), "
                                 f"{len(torch.unique(got.indices))} distinct of {r_final}, "
                                 f"L(S) {float(got.coverage)}")
        want = topo.n_leaves * r_local
        if launches["fl_gains_argmax"] != want:
            raise AssertionError(f"[16a] launches {launches}, expected {want} fl_gains_argmax")
        if len(calls) != plan or any(dv != str(x.device) for _, _, dv in calls):
            raise AssertionError(f"[16a] {len(calls)} all_gather_into_tensor calls {calls}, "
                                 f"planned {plan} on {x.device}")
        log(f"[16a] tree_select_mesh over a DeviceMesh {dict(zip(axes, mesh.mesh.shape))} of one "
            f"NCCL rank (local levels {k}, fan-outs {topo.fanouts}, {topo.n_leaves} device leaves "
            f"of {MESH_TREE_N // topo.n_leaves} × {x.shape[1]}, r_local {r_local}, r_final "
            f"{r_final}, int8 wire): {mesh_s:.3f}s, launches {launches}; {len(calls)} "
            f"all_gather_into_tensor = collectives_plan {plan} ({calls}); bit for bit "
            f"tree_select_host on the same rows ({host_s:.3f}s); group set-up (NCCL "
            f"init, make_tree_mesh, a first barrier) {setup_s:.3f}s; phase 11 (b)'s host tree "
            f"(8, 4) on the whole pool: {host_11b['int8']:.3f}s int8, {host_11b['none']:.3f}s "
            f"fp32; L(S) {float(got.coverage):.4f}, Σγ {float(got.weights.sum()):.0f}; {card}")
        del x, got, host

        # (c) the rank extract and the refresh's two rounds, in the same group
        extracted = extract_over_ranks(torch, ops, card, dev, dp_11d)
    finally:
        dist.destroy_process_group()

    # (b) the launcher: one process over NCCL, and two beside it
    args = ["--driver", "mesh", "--fanouts", MESH_PROC_FANOUTS, "--n", str(PROC_N),
            "--d", str(PROC_D), "--r-local", str(PROC_R_LOCAL), "--r-final",
            str(PROC_R_FINAL), "--device", "cuda"]
    fanouts = tuple(int(f) for f in MESH_PROC_FANOUTS.split(","))
    host = tree_select_host(torch.from_numpy(_synthetic_pool(PROC_N, PROC_D, 0)).to(dev),
                            TreeTopology(fanouts), PROC_R_LOCAL, PROC_R_FINAL, compress="int8")
    # the two processes start beside the one (with one card they are
    # refused before they touch it)
    cards = torch.cuda.device_count()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        pair = pool.submit(launch_tree, 2, args)
        rec = hold_tree_records("[16b]", launch_tree(1, args), host)
        one_s = time.perf_counter() - t0
        res = pair.result()
        two_s = time.perf_counter() - t0
    log(f"[16b] launch/tree.py --driver mesh, 1 process on {rec['device']} (fan-outs "
        f"{MESH_PROC_FANOUTS}, {PROC_N} × {PROC_D}, r_local {PROC_R_LOCAL}, r_final "
        f"{PROC_R_FINAL}, int8 wire): {one_s:.1f}s (process start included, beside the "
        f"two below); bit for bit tree_select_host; Σγ {rec['weight_sum']:.0f}; {card}")
    if cards >= 2:
        hold_tree_records("[16b] 2 processes:", res, host)
        log(f"[16b] 2 processes on {cards} cards: {two_s:.1f}s; both bit for bit "
            f"tree_select_host; {card}")
    else:
        for rc, out, err in res:
            if rc == 0 or "TREE_SELECT_RESULT" in out or "one rank per card" not in err:
                raise AssertionError(f"[16b] 2 processes on {cards} card: exit {rc}, expected "
                                     f"the one-rank-per-card error: {err[-2000:]}")
        log(f"[16b] 2 processes on {cards} card: both refused before any group started "
            f"({two_s:.1f}s): {err.strip().splitlines()[-1]}")
    log(f"[16] phase total {time.perf_counter() - t_phase:.1f}s; {card}")
    return {k: launches[k] + extracted[k] for k in launches}


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
                err, pg = hold_argmax(torch, ops, x, cur, sq, d_max, chosen, tile,
                                      f"fl_gains_argmax {tile} n={n} d={d}")
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
                "issue_bound_ms": 1e3 * issue_seconds(torch, "fl_gains", n, n, d, sm_clock),
            }
            if n == CLASS_SIZES[0]:
                results[kname] = r
            log(f"[2] {kname} at n=m={n}, d={d}: {r}")
    results["ce_proxy"] = check_ce_proxy(torch, ops, kce, dev, gen,
                                         (fp32_peak, bf16_peak, mem_bw), card)
    max_err.update(check_slice3_kernels(torch, ops, dev, gen))
    results.update(check_adamw(torch, card, dev, mem_bw))
    for kname in ADAMW_KERNELS:
        max_err[kname] = results[kname].pop("max_abs_err")

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
    from repro_torch.configs import get_config
    from repro_torch.optim import warmup_cosine

    lm_cfg = get_config(LM_ARCH)
    sync = train_lm(torch, ops, card, dev, lm_cfg, MAIN_DOCS, "sync", MAIN_STEPS,
                    warmup_cosine(3e-4, 10, MAIN_STEPS), (3, 2), "main path")
    results["ce_proxy"]["launches"] = sync["launches"]
    # the trainer's default mode: the first selection overlaps epoch 0
    asyn = train_lm(torch, ops, card, dev, lm_cfg, MAIN_DOCS, "async", MAIN_ASYNC_STEPS,
                    warmup_cosine(3e-4, 10, MAIN_STEPS), (2, 1), "async")
    # Both modes train on the full data until the first install, from the
    # same seed: bf16 steps through cuBLAS and the embedding's scattered
    # backward need not repeat bit for bit, so a relative 1e-2.
    n0 = MAIN_DOCS // LM_BATCH
    drift = max(abs(a - b) / abs(b) for a, b in zip(asyn["losses"][:n0], sync["losses"][:n0]))
    if drift > 1e-2:
        raise AssertionError(f"async and sync epoch-0 losses differ by {drift:.3e} (rel)")
    log(f"[6] async against sync, epoch 0: largest relative loss difference {drift:.3e}")
    for kname in ADAMW_KERNELS:
        results[kname]["launches"] = sync["adamw"][kname] + asyn["adamw"][kname]
    max_err["ce_proxy"] = results["ce_proxy"]["max_abs_err"]

    # -- 7. Covtype-shaped selection: the slice-3 sparse path ---------------
    peaks = (fp32_peak, bf16_peak, mem_bw)
    cov_feats, cov_y = covtype_pool(dev)
    results.update(covtype_selection(torch, ops, card, dev, peaks, cov_feats, cov_y))
    for kname in ("topk_sim", "pairwise_l2"):
        max_err[kname] = max(max_err[kname], results[kname].pop("max_abs_err_main", 0.0))

    # -- 8. the streaming coreset service: the slice-3 serving path --------
    results["fl_replay"] = coreset_service(torch, ops, card, dev, peaks)
    max_err["fl_replay"] = max(max_err["fl_replay"], results["fl_replay"].pop("max_abs_err_main"))

    # -- 9. LM coreset training at the published widths: slice 7's path -----
    wide = wide_lm_training(torch, ops, card, dev)
    results["ce_proxy"]["launches"] += sum(r["launches"] for r in wide.values())
    for kname in ADAMW_KERNELS:
        results[kname]["launches"] += sum(r.get("adamw", {}).get(kname, 0)
                                          for r in wide.values())

    # -- 10. the lazy and stochastic engines; the streaming-ingest trainer ---
    t0 = time.perf_counter()
    stochastic_selection(torch, parity, card, dev, feats, y, cs)
    lazy_selection(torch, parity, card, dev, xr, yr)
    streamed = streaming_lm_training(torch, ops, card, dev)
    for kname, n in streamed.items():
        results[kname]["launches"] += n
    log(f"[10] phase total {time.perf_counter() - t0:.1f}s")

    # -- 11. distributed selection and the data-parallel extract -----------
    mesh_sweep = start_mesh_sweep()  # phase 14 (a), host work beside 11–13
    atexit.register(stop_sweep, mesh_sweep)  # whatever phase fails
    t0 = time.perf_counter()
    spread, spread_err, host_11b, dp_11d = distributed_selection(torch, ops, card, dev,
                                                                 cov_feats)
    for kname in ("topk_sim", "pairwise_l2", "ce_proxy"):
        results[kname]["launches"] += spread[kname]
    for kname, e in spread_err.items():
        max_err[kname] = max(max_err[kname], e)
    log(f"[11] phase total {time.perf_counter() - t0:.1f}s; launches {spread}")
    del cov_feats

    # -- 12. serving: prefill and KV-cache decode; 13 (b) on its models ------
    t0 = time.perf_counter()
    sweep = start_dryrun_sweep()
    try:
        rows: list = []
        serving(torch, card, dev, mem_bw,
                reckoned_cells(torch, card, dev, (fp32_peak, bf16_peak, mem_bw), rows))
        real_s = sum(r.get("phase_s", 0.0) for r in rows)
        log(f"[12] phase total {time.perf_counter() - t0 - real_s:.1f}s (phase 13 (b)'s "
            f"{real_s:.1f}s apart)")

        # -- 13. the dry run and the roofline --------------------------------
        t0 = time.perf_counter()
        dry = dryrun_report(torch, card, sweep, rows)
    finally:
        stop_sweep(sweep)
    results["ce_proxy"]["launches"] += dry["launches"]
    max_err["ce_proxy"] = max(max_err["ce_proxy"], dry["ce_err"])
    log(f"[13] phase total {time.perf_counter() - t0 + dry['real_s']:.1f}s ((b) "
        f"{dry['real_s']:.1f}s inside phase 12's cells, (a)'s report "
        f"{time.perf_counter() - t0:.1f}s after it)")

    # -- 14. model parallelism: the production meshes; a world-1 mesh ------
    t0 = time.perf_counter()
    try:
        one = world_one(torch, ops, card, dev)
        mesh_report(torch, card, mesh_sweep)
    finally:
        stop_sweep(mesh_sweep)
    results["ce_proxy"]["launches"] += one["launches"]
    max_err["ce_proxy"] = max(max_err["ce_proxy"], one["ce_err"])
    log(f"[14] phase total {time.perf_counter() - t0:.1f}s")

    # -- 15. static analysis --------------------------------------------------
    static_analysis(torch, card, dev)

    # -- 16. tree selection over a group of ranks -------------------------------
    ranked = tree_over_ranks(torch, ops, card, dev, host_11b, dp_11d)
    results["ce_proxy"]["launches"] += ranked["ce_proxy"]

    # -- 17. report ---------------------------------------------------------
    results["fl_gains_argmax"]["launches"] = (main_launches["fl_gains_argmax"]
                                              + spread["fl_gains_argmax"]
                                              + ranked["fl_gains_argmax"])
    kernels = []
    for kname in REPLACES:
        r = results[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": r["launches"],
            "max_abs_err": max_err[kname], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
        })
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel of the path was never launched: {kernels}")
    log(f"[17] ce_proxy fp32 at the main-path shape: {results['ce_proxy']['fp32']}")
    log(f"[17] total {time.perf_counter() - t_start:.1f}s; {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
