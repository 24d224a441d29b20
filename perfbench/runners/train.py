"""Runner ``train``: ``repro_torch.train.Trainer.run`` as users run it.

``refresh_mode``, ``proxy_impl`` and ``engine`` come from the mix (the
trainer's defaults, ``'async'`` and ``'auto'``, in both mixes here), AdamW,
the mix's corpus and batches.  Set-up builds the kernels (first run in a
checkout only), makes the corpus and the weights from ``--seed``, builds
one ``Trainer`` and drives it through the mix's first epoch; its first
steps are the ones the reference follows.  The window then runs whole
epochs until ``--seconds`` have passed and ends at the next install
(with a refresh every epoch, the wait for the refresh in flight), so its
rates take all the work over all the time.

The runner observes the program through thin wrappers around the
trainer's own calls (``Probe``): each step's feed, each refresh's submit,
features and published selection, the gradient the optimizer gets in the
first step after each submit, and ``bench.*`` spans for a traced run.
After the window it reads the peak memory, frees the program's state and
runs the plain reference (``reference/``), which recomputes what the
program derived from the benchmark's own inputs, except where it can only
start from the program's state (the window's last refresh snapshot, which
is also the parameters of the weighted step that follows that submit, and
the previous selection the refresh warm-starts from).

The configuration is a dense SwiGLU decoder (``perfbench.model_shape``);
the mix's keys are ``MIX_KEYS``, each read here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import subprocess
import time

import numpy as np
import torch

from perfbench import check as ck
from perfbench import counts
from perfbench import weights as W
from perfbench.corpus import Corpus, derive_seed
from perfbench.model_shape import Shape
from perfbench.reference import greedy as rg
from perfbench.reference import model as rm
from perfbench.reference.training import adamw_steps, loss_and_grad_norms
from perfbench.trace import SPAN_PREFIX, summarize

__all__ = ["MIX_KEYS", "PLANTS", "Run", "run", "card_lines", "port_config"]

MIX_KEYS = frozenset({
    "docs", "seq_len", "n_topics", "batch", "use_craig", "fraction", "select_every_epochs",
    "refresh_mode", "warm_start_fraction", "proxy_impl", "engine", "optimizer", "check_steps",
    "check_docs", "reference_rows"})

# Faults the check must catch, planted beneath the timed path by
# ``plant=`` (tests and calibration only; a benchmark run plants nothing).
PLANTS = ("unchanged", "half_batch", "ignore_weights", "answer")


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run (``metrics/<name>.py``)."""

    shape: Shape
    mix: dict
    setup_s: float
    window_s: float
    steps: list  # the trainer's step records of the window
    stalls: list  # install waits of the window, seconds
    refreshes: list  # refreshes published in the window (Probe records)
    tokens_per_step: int
    peak_bytes: int
    model_flops: float
    peaks: dict
    trace: object = None  # trace.TraceSummary of a traced run


@dataclasses.dataclass
class Outcome:
    """What the harness judges and reports of one run."""

    run: Run
    numbers: dict  # compared against the cell's limits
    shown: dict  # readings shown beside them, not compared
    attempted: int
    failed: int


class _Feed:
    """The trainer's view of the corpus: records the documents of every
    training batch (the extractor keeps the corpus itself)."""

    def __init__(self, corpus: Corpus):
        self._corpus = corpus
        self.served: list[np.ndarray] = []

    def __getattr__(self, name):
        return getattr(self._corpus, name)

    def batch(self, idx):
        self.served.append(np.asarray(idx, np.int64).copy())
        return self._corpus.batch(idx)


class Probe:
    """Wrappers around the trainer's calls that record what the check and
    the metrics need.  ``held`` keeps the newest refresh's parameter
    snapshot until the next submit, so the check can recompute that
    refresh and the step after it; ``wstep`` is that step: its index among
    all steps and the norm of each gradient leaf as the optimizer got it
    (before clipping), left on the device until the window has closed."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.weights: list = []
        self.refreshes: list[dict] = []
        self.held = None
        self.wstep = None
        self._armed = self._want_norms = False

    def optimizer(self, opt):
        """``opt`` with an ``update`` that, in the first step after a
        submit, keeps the norm of each gradient leaf it is given."""

        def update(grads, state, params):
            if self._want_norms:
                self._want_norms = False
                with torch.no_grad():
                    self.wstep["names"] = list(grads)
                    self.wstep["norms"] = torch.stack(
                        [torch.linalg.vector_norm(g.float()) for g in grads.values()])
            return opt.update(grads, state, params)

        return dataclasses.replace(opt, update=update)

    def attach(self, trainer) -> None:
        """Wraps the trainer's calls (after any fault planted beneath)."""
        self.feed = _Feed(trainer.dataset)
        trainer.dataset = self.feed
        step, submit = trainer.train_step, trainer.refresher.submit
        extract, stage = trainer.extractor.extract, trainer.sampler.stage
        wait = trainer.refresher.wait

        def train_step(params, opt_state, batch):
            self.weights.append(batch["weights"])
            if self._armed:
                self._armed, self._want_norms = False, True
                self.wstep = {"index": len(self.weights) - 1}
            try:
                with self.span("train_step"):
                    return step(params, opt_state, batch)
            finally:
                self._want_norms = False

        def submit_(params):
            self.held = None
            self._armed = True
            self.refreshes.append({"t_submit": time.perf_counter()})
            with self.span("submit"):
                return submit(params)

        def extract_(params, pool_idx):
            with self.span("extract"):
                feats = extract(params, pool_idx)
            rec = self.refreshes[-1]
            rec["pool_idx"] = np.asarray(pool_idx).copy()
            rec["feats"] = feats.detach().clone()
            self.held = params
            return feats

        def stage_(indices, weights, version=None, meta=None, keep_order=False):
            self.refreshes[-1].update(
                t_publish=time.perf_counter(), indices=np.asarray(indices).copy(),
                gammas=np.asarray(weights, np.float64).copy(), version=version,
                meta=dict(meta or {}))
            return stage(indices, weights, version=version, meta=meta, keep_order=keep_order)

        def wait_(timeout=None):
            with self.span("install_wait"):
                return wait(timeout)

        trainer.train_step, trainer.refresher.submit = train_step, submit_
        trainer.extractor.extract, trainer.sampler.stage = extract_, stage_
        trainer.refresher.wait = wait_

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)


def _plant(trainer, kind: str, model_cfg) -> None:
    """Break the timed path underneath (tests and calibration only).  The
    step faults go beneath the probe; the swapped answer above it, so that
    the probe records what the program published."""
    if kind == "unchanged":  # a step that returns its state unchanged
        from repro_torch.models import loss_fn

        def step(params, opt_state, batch):
            with torch.no_grad():
                _, m = loss_fn(params, model_cfg, batch)
            return params, opt_state, {"loss": m["loss"], "aux_loss": m["aux_loss"],
                                       "step": opt_state.step}

        trainer.train_step = step
    elif kind == "half_batch":  # half the rows left out, the mean over the rest
        inner = trainer.train_step
        trainer.train_step = lambda p, o, b: inner(
            p, o, {k: v[: v.shape[0] // 2] for k, v in b.items()})
    elif kind == "ignore_weights":  # the loss drops the rows' weights: a plain mean
        inner = trainer.train_step
        trainer.train_step = lambda p, o, b: inner(
            p, o, {**b, "weights": torch.ones_like(b["weights"])})
    elif kind == "answer":  # one selected document swapped where it is published
        stage = trainer.sampler.stage

        def stage_(indices, weights, **kw):
            indices = np.asarray(indices).copy()
            free = np.setdiff1d(np.arange(trainer.dataset.n_docs), indices)
            indices[-1] = free[0]
            return stage(indices, weights, **kw)

        trainer.sampler.stage = stage_
    else:
        raise ValueError(f"unknown fault {kind!r} (want one of {PLANTS})")


def port_config(shape: Shape):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(
        name=shape.name, family="dense", n_layers=shape.n_layers, d_model=shape.d_model,
        n_heads=shape.n_heads, n_kv_heads=shape.n_kv_heads, d_ff=shape.d_ff,
        vocab_size=shape.vocab_size, d_head=shape.head_dim, qkv_bias=shape.qkv_bias,
        activation="silu", rope_theta=shape.rope_theta, norm_eps=shape.norm_eps,
        tie_embeddings=shape.tied)


def _check_program_matches(shape: Shape, model_cfg) -> None:
    """The program runs what the configuration states: its layout and its
    compute dtype."""
    from repro_torch.models import model as pm

    if str(pm.COMPUTE_DTYPE).removeprefix("torch.") != shape.compute_dtype:
        raise RuntimeError(f"the program computes in {pm.COMPUTE_DTYPE}; the configuration "
                           f"states {shape.compute_dtype}")
    want = {n: tuple(s) for n, s, _, _ in shape.leaves()}
    if pm.param_shapes(model_cfg) != want:
        raise RuntimeError("the program's parameter layout is not the configuration's")


def card_lines(device) -> list[str]:
    if torch.device(device).type != "cuda":
        return []
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return [f"card: {line.strip()}" for line in out.stdout.strip().splitlines()]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def change_norms(shape: Shape, seed: int, params: dict, device) -> dict:
    """‖p_k − p0_k‖ by leaf, the initial weights drawn again a group at a time."""
    out = {}
    for name in W.groups(shape):
        p0 = W.group(shape, seed, name, device)
        for k, v in p0.items():
            out[k] = float(torch.linalg.vector_norm(params[k].float() - v))
        del p0
    return out


def _optimizer(mix: dict):
    from repro_torch.optim import adamw, constant

    o = mix["optimizer"]
    return adamw(constant(o["lr"]), b1=o["b1"], b2=o["b2"], eps=o["eps"],
                 weight_decay=o["weight_decay"], clip=o["clip"])


def _trainer_config(mix: dict, seed: int):
    from repro_torch.core.craig import CraigConfig
    from repro_torch.train import TrainerConfig

    return TrainerConfig(
        batch_size=mix["batch"], select_every_epochs=mix["select_every_epochs"],
        craig=CraigConfig(fraction=mix["fraction"], per_class=False, engine=mix["engine"]),
        use_craig=mix["use_craig"], proxy_pool_batches=mix["docs"] // mix["batch"],
        proxy_impl=mix["proxy_impl"], refresh_mode=mix["refresh_mode"],
        warm_start_fraction=mix["warm_start_fraction"],
        seed=derive_seed(seed, "sampler"))


def sample_docs(mix: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng(derive_seed(seed, "check docs"))
    return np.sort(rng.choice(mix["docs"], size=mix["check_docs"], replace=False))


def tensors(corpus: Corpus, idx, device):
    return (torch.as_tensor(corpus.tokens(idx), device=device),
            torch.as_tensor(corpus.labels(idx), device=device))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        plant: str | None = None, log=print) -> Outcome:
    """Runs ``cell`` once; ``plant`` breaks the timed path (tests,
    calibration)."""
    from repro_torch.kernels import ops
    from repro_torch.train import Trainer

    if plant is not None and plant not in PLANTS:
        raise ValueError(f"unknown fault {plant!r} (want one of {PLANTS})")
    mix, shape = cell.traffic, Shape.from_config(cell.config_name, cell.config)
    cuda = device.type == "cuda"
    model_cfg = port_config(shape)
    _check_program_matches(shape, model_cfg)
    for line in card_lines(device):
        log(line)
    marks = [("imports", time.perf_counter())]
    if cuda:
        from repro_torch.kernels import _build

        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
        marks.append(("kernel libraries", time.perf_counter()))
    corpus = Corpus(mix["docs"], mix["seq_len"], shape.vocab_size, mix["n_topics"],
                    derive_seed(seed, "corpus"))
    marks.append(("corpus", time.perf_counter()))
    params = W.make_params(shape, seed, device)
    probe = Probe(tracing=trace)
    trainer = Trainer(model_cfg, _trainer_config(mix, seed), corpus,
                      probe.optimizer(_optimizer(mix)), lambda: params, device=device)
    del params
    _sync(device)
    marks.append(("weights and trainer", time.perf_counter()))
    if plant in ("unchanged", "half_batch", "ignore_weights"):
        _plant(trainer, plant, model_cfg)
    probe.attach(trainer)
    if plant == "answer":
        _plant(trainer, plant, model_cfg)
    b1 = mix["optimizer"]["b1"]
    n_check = mix["check_steps"]
    grad1_p = None
    for i in range(n_check):
        trainer.run(1)
        if i == 0:
            grad1_p = {k: v / (1.0 - b1) for k, v in _norms(trainer.opt_state.inner["m"]).items()}
    change_p = change_norms(shape, seed, trainer.params, device)
    marks.append(("checked steps", time.perf_counter()))
    first_epoch = mix["docs"] // mix["batch"]
    trainer.run(first_epoch - n_check)
    _sync(device)
    marks.append(("first epoch", time.perf_counter()))
    log("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b) in
                               zip([("start", t_start)] + marks[:-1], marks)))

    # -- the measured window ------------------------------------------------
    n_log, n_steps_before = len(trainer.metrics_log), trainer.step
    launches0 = dict(ops.LAUNCHES)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    with probe.span("window"):
        while True:
            trainer.run(1)
            if trainer.sampler.step_in_epoch == 0 and time.perf_counter() - t0 >= seconds:
                break
        if mix["use_craig"]:
            tw = time.perf_counter()
            trainer.refresher.wait()
            stalls_final = time.perf_counter() - tw
        _sync(device)
    t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = {k: ops.LAUNCHES[k] - launches0[k] for k in launches0}
    for line in card_lines(device):
        log(line)

    window_log = trainer.metrics_log[n_log:]
    steps = [m for m in window_log if m["event"] == "step"]
    installs = [m for m in window_log if m["event"] == "craig_refresh"]
    failures = [m for m in window_log if m["event"] == "craig_refresh_failed"]
    stalls = [m["install_stall_s"] for m in installs]
    if mix["use_craig"]:
        stalls.append(stalls_final)
    published = [r for r in probe.refreshes if "t_publish" in r and t0 <= r["t_publish"] <= t1]
    submitted = [r for r in probe.refreshes if r["t_submit"] >= t0]
    tokens = mix["batch"] * mix["seq_len"]
    flops = (len(steps) * counts.train_step_flops(shape, mix["batch"], mix["seq_len"])
             + len(submitted) * (mix["docs"] // mix["batch"])
             * counts.extract_flops(shape, mix["batch"], mix["seq_len"]))
    summary = summarize(prof) if prof is not None else None
    run_ = Run(shape=shape, mix=mix, setup_s=t0 - t_start, window_s=t1 - t0, steps=steps,
               stalls=stalls, refreshes=published, tokens_per_step=tokens, peak_bytes=peak,
               model_flops=flops,
               peaks=counts.peaks(torch.cuda.get_device_name(device)) if cuda
               else dict(counts.H100_PEAKS),
               trace=summary)
    losses_all = [m["loss"] for m in trainer.metrics_log if m["event"] == "step"]
    window_served = probe.feed.served[n_steps_before:]
    window_weights = [w.detach().cpu().numpy() for w in probe.weights[n_steps_before:]]
    check_served = probe.feed.served[:n_check]
    first, last = (probe.refreshes[0], probe.refreshes[-1]) if probe.refreshes else (None, None)
    prev = probe.refreshes[-2] if len(probe.refreshes) > 1 else None
    all_refreshes = probe.refreshes
    held = probe.held
    wstep = None
    if mix["use_craig"]:
        j, w = probe.wstep["index"], probe.wstep
        wstep = {"served": probe.feed.served[j], "loss": losses_all[j],
                 "norms": dict(zip(w["names"], w["norms"].tolist())) if "norms" in w else None,
                 "installed": _installed(j + 1, installs, all_refreshes)}

    # -- the check: the program's state freed, the reference alone ----------
    del trainer, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rm.no_tf32()
    numbers = {}
    mm = rm.Matmul("fp32")
    rows = mix["reference_rows"]
    sample = sample_docs(mix, seed)
    if mix["use_craig"]:
        numbers["featw_gap"] = ck.row_gap(last["feats"],
                                          pool_features(held, shape, corpus, last["pool_idx"],
                                                        mm, rows, device))
        numbers.update(weighted_step_numbers(held, shape, corpus, wstep, mm, rows, device))
        del held
        numbers.update(_selection_numbers(last, prev, mix))
        numbers["install_miss"] = _install_miss(window_served, window_weights, installs,
                                                n_steps_before, all_refreshes)
    p = W.make_params(shape, seed, device)
    if mix["use_craig"]:
        tok, lab = tensors(corpus, sample, device)
        pos = {int(d): i for i, d in enumerate(first["pool_idx"])}
        want = rm.proxy_features(p, shape, tok, lab, mm, rows)
        numbers["feat0_gap"] = ck.row_gap(first["feats"][[pos[int(d)] for d in sample]], want)
        del want
    batches = []
    for idx in check_served:
        t, lab_ = tensors(corpus, idx, device)
        batches.append((t, lab_, torch.ones(len(idx), device=device)))
    ref = adamw_steps(p, shape, batches, mix["optimizer"], mm, rows)
    change_r = change_norms(shape, seed, p, device)
    del p, batches
    step_gaps = ck.step_gaps(losses_all[:n_check], ref["losses"])
    numbers["loss1_gap"] = step_gaps[0]
    numbers["grad1_gap"] = ck.norm_gap(grad1_p, ref["grad1"])
    numbers["change3_gap"] = ck.norm_gap(change_p, change_r, keep=ck.moving_leaves(ref["grad1"]))
    log(f"check: {time.perf_counter() - t1:.3f} s")

    failed = sum(not math.isfinite(m["loss"]) for m in steps) + len(failures)
    # the program's own launch counts, beside what the refreshes need and
    # (traced) the kernels the profiler saw
    want = len(submitted) * (mix["docs"] // mix["batch"]) if cuda and mix["use_craig"] else 0
    traced = "" if summary is None else f", in the trace {summary.time_of('ce_proxy')[1]}"
    log(f"window: {run_.window_s!r} s, {len(steps)} steps, {len(published)} refreshes "
        f"published in {[r['t_publish'] - r['t_submit'] for r in published]!r} s, "
        f"install waits {stalls!r}; ce_proxy launches {launches['ce_proxy']} "
        f"(refreshes need {want}{traced}); set-up {run_.setup_s!r} s")
    return Outcome(run=run_, numbers=numbers, shown={"loss_gaps": step_gaps},
                   attempted=len(steps) + len(submitted), failed=failed)


def pool_features(params: dict, shape: Shape, corpus: Corpus, pool_idx, mm, rows: int,
                  device) -> torch.Tensor:
    """The reference's proxy features of every pool document, in the
    pool's order."""
    tok, lab = tensors(corpus, np.asarray(pool_idx), device)
    return rm.proxy_features(params, shape, tok, lab, mm, rows)


def reference_weights(installed: dict, served, device) -> torch.Tensor:
    """Each served document's weight γ·r/Σγ, from the installed selection's
    published γ (r its size), worked out again in float64."""
    g = dict(zip((int(d) for d in installed["indices"]), installed["gammas"]))
    scale = len(installed["indices"]) / float(np.sum(installed["gammas"], dtype=np.float64))
    w = np.array([g[int(d)] * scale for d in served], np.float64)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def weighted_step_numbers(params: dict, shape: Shape, corpus: Corpus, wstep: dict, mm,
                          rows: int, device) -> dict:
    """wstep_loss_gap and wstep_grad_gap: the first step after the window's
    last submit, from that submit's snapshot (the parameters the step
    started from), on the step's own documents weighted by the installed
    coreset's γ.  A step that never reached the optimizer reads NaN."""
    if wstep["installed"] is None:  # no selection trained the step
        return {"wstep_loss_gap": math.nan, "wstep_grad_gap": math.nan}
    tok, lab = tensors(corpus, wstep["served"], device)
    w = reference_weights(wstep["installed"], wstep["served"], device)
    ref = loss_and_grad_norms(params, shape, tok, lab, w, mm, rows)
    grad = math.nan if wstep["norms"] is None else ck.norm_gap(wstep["norms"], ref["norms"])
    return {"wstep_loss_gap": abs(wstep["loss"] - ref["loss"]) / abs(ref["loss"]),
            "wstep_grad_gap": grad}


def _selection_numbers(last: dict, prev: dict | None, mix: dict) -> dict:
    """select_gap and gamma_gap of the window's last refresh, from the
    program's features of it (each row held to the reference's by
    featw_gap), warm-started as the program was (the first
    ``warm_start_fraction`` of the previous selection, greedy order)."""
    x = last["feats"].double()
    n = x.shape[0]
    pos = {int(d): i for i, d in enumerate(last["pool_idx"])}
    budget = max(1, int(round(mix["fraction"] * n)))
    init = []
    if prev is not None and mix["warm_start_fraction"] > 0:
        r0 = int(round(mix["warm_start_fraction"] * len(prev["indices"])))
        init = [pos[int(d)] for d in prev["indices"][:r0]]
    dist = rg.distances(x)
    mine = [pos[int(d)] for d in last["indices"]]
    theirs = rg.greedy(dist, budget, init)
    l_ref = rg.coverage(dist, theirs)
    gam = rg.cluster_sizes(dist, mine).cpu().numpy()
    return {"select_gap": abs(rg.coverage(dist, mine) - l_ref) / l_ref,
            "gamma_gap": float(np.abs(np.asarray(last["gammas"]) - gam).sum() / n)}


def _installed(step_no: int, installs: list, refreshes: list) -> dict | None:
    """The refresh whose selection trains step ``step_no``: the newest
    install logged before it (an install logged at step s precedes step
    s + 1)."""
    by_version = {r["version"]: r for r in refreshes if "version" in r}
    active = [m["version"] for m in installs if m["step"] < step_no]
    return by_version[active[-1]] if active else None


def _install_miss(served: list, weights: list, installs: list, first_step: int,
                  refreshes: list) -> float:
    """Window rows whose document is not in the coreset installed before
    their step, or whose weight is not that document's γ·r/Σγ.  The j-th
    window step is step ``first_step + j + 1``."""
    miss = 0
    for j, (idx, w) in enumerate(zip(served, weights, strict=True)):
        rec = _installed(first_step + j + 1, installs, refreshes)
        if rec is None:
            miss += len(idx)
            continue
        g = dict(zip((int(d) for d in rec["indices"]), rec["gammas"]))
        scale = len(rec["indices"]) / float(np.sum(rec["gammas"]))
        for d, wd in zip(idx, w):
            want = g.get(int(d))
            if want is None or abs(float(wd) - want * scale) > 1e-6 * want * scale:
                miss += 1
    return float(miss)
