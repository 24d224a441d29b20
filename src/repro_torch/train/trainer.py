"""Trainer: the host loop that ties CRAIG selection into LM training.

Port of ``repro.train.trainer`` (``TrainerConfig``, ``Trainer``), single
device.  Responsibilities, as in the reference:

* CRAIG refresh every ``select_every_epochs`` epochs (paper §3.4): params
  are snapshotted at the epoch boundary, proxy extraction
  (``core.extract``, through ``make_select_step(proxy_impl)`` — the
  ``ce_proxy`` kernel on a card) and ``CraigSelector`` selection run on the
  refresher (a worker thread in ``'async'`` mode, inline in ``'sync'``),
  and the published selection installs at the next epoch boundary while
  training continues on the installed coreset;
* warm start from the previous selection's high-gain prefix
  (``warm_start_fraction``);
* per-class stratification by ``dataset.class_labels`` when
  ``craig.per_class``;
* γ-weighted training between refreshes (the weights ride in the batch);
* streaming ingest (``streaming_ingest=True``) for corpora that grow:
  each refresh boundary queues only the documents appended since the last
  one through ``AsyncRefresher.ingest``; a drain extracts their proxies,
  feeds them to a ``StreamingSelector`` (sieve streaming, O(Δn·k) a
  delta), evicts pool rows no sieve references (``streaming_evict``) and
  finalizes, instead of re-extracting the whole pool;
* checkpoint/restart of params, optimizer state, sampler cursor, installed
  and staged coresets, the warm-start seed and the streaming state
  (``restore_or_init``);
* preemption: SIGTERM (or ``request_preempt``) saves at the next step
  boundary and stops;
* a per-step wall-clock watchdog that records stragglers.

Each refresh's metadata also records the extraction and selection seconds
separately (``extract_time_s``, ``selection_time_s``; a streaming drain
``extract_time_s``, ``ingest_time_s`` and ``finalize_time_s``; on a card
each ends in a device synchronise).
"""
from __future__ import annotations

import dataclasses
import signal
import time
import warnings
from typing import Any, Callable, Literal

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.craig import CoresetSelection, CraigConfig, CraigSelector
from repro_torch.core.engines.streaming import StreamingSelector, StreamingState
from repro_torch.core.extract import ProxyExtractor
from repro_torch.core.refresh import AsyncRefresher, RefreshResult, snapshot, weak_callback
from repro_torch.data.pipeline import CoresetSampler, to_device
from repro_torch.faults import FailurePolicy
from repro_torch.models import loss_fn as model_loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.train_step import make_select_step, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    batch_size: int = 8
    eval_every: int = 0  # steps between held-out evals (0 = never)
    eval_batches: int = 2
    select_every_epochs: int = 1  # CRAIG refresh cadence (0 = never)
    craig: CraigConfig = dataclasses.field(
        default_factory=lambda: CraigConfig(fraction=0.5, per_class=False)
    )
    use_craig: bool = True
    proxy_pool_batches: int = 8  # batches of the pool scanned per refresh
    proxy_impl: str = "auto"  # select-step CE head: auto|einsum|cuda|torch
    extract_megabatch: int = 0  # pool batches per host assembly (0 = all)
    extract_prefetch: bool = True  # assemble the next megabatch meanwhile
    refresh_mode: Literal["sync", "async"] = "async"
    warm_start_fraction: float = 0.5  # share of the budget warm-started
    streaming_ingest: bool = False  # grow-only corpora: ingest the docs
    # appended since the last boundary (budget fixed at craig.fraction × the
    # first delta) instead of re-extracting the pool every refresh
    streaming_evict: bool = True  # drop pool rows no sieve references after
    # every drain (O(L·k·d) pool instead of O(n·d))
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    step_timeout_s: float | None = None  # straggler watchdog
    microbatches: int = 1
    seed: int = 0
    refresh_failure_policy: FailurePolicy | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# refresh metadata a streaming drain adds to its craig_refresh event
_STREAM_META = ("n_seen", "n_live", "ingest_time_s", "finalize_time_s")


class Trainer:
    """Single-device trainer; runs on ``device`` (the card unless the
    caller asks for the CPU).  ``init_params_fn()`` returns the fp32
    parameter dict on that device."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        dataset,
        optimizer: Optimizer,
        init_params_fn: Callable[[], dict],
        eval_dataset=None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.dataset = dataset
        self.eval_dataset = eval_dataset
        self.optimizer = optimizer
        self.sampler = CoresetSampler(dataset.n_docs, tcfg.batch_size, tcfg.seed)
        self.train_step = make_train_step(cfg, optimizer, microbatches=tcfg.microbatches)
        self.extractor = ProxyExtractor(
            make_select_step(cfg, proxy_impl=tcfg.proxy_impl),
            dataset,
            tcfg.batch_size,
            megabatch=tcfg.extract_megabatch or max(1, tcfg.proxy_pool_batches),
            prefetch=tcfg.extract_prefetch,
        )
        self.params = init_params_fn()
        self.opt_state = optimizer.init(self.params)
        self.step = 0
        self.metrics_log: list[dict] = []
        self.straggler_events: list[int] = []
        self._preempt = False
        self.ckpt = (
            CheckpointManager(tcfg.checkpoint_dir, tcfg.keep_checkpoints)
            if tcfg.checkpoint_dir
            else None
        )
        self._last_epoch_selected = -1
        # weak callbacks: the refresher must not hold the trainer (and
        # its parameters and optimizer state) alive in a reference cycle
        stream = tcfg.use_craig and tcfg.streaming_ingest
        self.refresher = AsyncRefresher(
            weak_callback(self._refresh_work),
            mode=tcfg.refresh_mode,
            on_complete=weak_callback(self._publish_stream if stream else self._publish_refresh),
            ingest_fn=weak_callback(self._stream_ingest_job) if stream else None,
            failure_policy=tcfg.refresh_failure_policy,
            on_failure=weak_callback(self._refresh_failed),
        )
        # streaming state: the selector is built at the first drain (budget
        # = fraction × first delta); the pool (on the device) and its doc
        # ids are compacted in lockstep with StreamingSelector.compact()
        self._stream_cursor = 0  # docs ingested so far (a dataset prefix)
        self._stream_sel: StreamingSelector | None = None
        self._stream_pool: torch.Tensor | None = None
        self._stream_doc_ids = np.zeros((0,), np.int64)
        # previous refresh's selection in pool coordinates (the pool is a
        # fixed stride, identical across refreshes): the warm-start seed
        self._prev_selection: CoresetSelection | None = None
        if tcfg.use_craig and tcfg.craig.per_class and not hasattr(dataset, "class_labels"):
            warnings.warn(
                "craig.per_class=True but the dataset exposes no "
                "class_labels(idx); refreshes will fall back to flat "
                "(unstratified) selection",
                UserWarning,
                stacklevel=2,
            )

    # -- preemption -----------------------------------------------------------

    def install_signal_handler(self) -> None:
        signal.signal(signal.SIGTERM, lambda *_: self.request_preempt())

    def request_preempt(self) -> None:
        self._preempt = True

    # -- CRAIG refresh ---------------------------------------------------------

    def _pool_indices(self) -> np.ndarray:
        """Deterministic candidate pool: a stride over the corpus."""
        n_pool = min(self.dataset.n_docs, self.tcfg.proxy_pool_batches * self.tcfg.batch_size)
        stride = max(1, self.dataset.n_docs // n_pool)
        return np.arange(0, self.dataset.n_docs, stride)[:n_pool]

    def _pool_labels(self, pool_idx: np.ndarray) -> np.ndarray | None:
        if self.tcfg.craig.per_class and hasattr(self.dataset, "class_labels"):
            return np.asarray(self.dataset.class_labels(pool_idx))
        return None

    def _refresh_work(self, params):
        """Extraction + selection on a parameter snapshot (the worker
        thread in async mode).  Features stay on the device."""
        pool_idx = self._pool_indices()
        labels = self._pool_labels(pool_idx)
        t0 = time.perf_counter()
        feats = self.extractor.extract(params, pool_idx)
        _sync(self.device)
        t1 = time.perf_counter()
        init = None
        prev = self._prev_selection
        if self.tcfg.warm_start_fraction > 0 and prev is not None:
            r0 = int(round(self.tcfg.warm_start_fraction * prev.size))
            if r0 > 0:
                init = np.asarray(prev.indices[:r0])
        selector = CraigSelector(self.tcfg.craig, device=self.device)
        sel = selector.select(feats, labels=labels, init_selected=init)
        t2 = time.perf_counter()
        self._prev_selection = sel
        return sel, pool_idx, {"extract_time_s": t1 - t0, "selection_time_s": t2 - t1}

    def _publish_refresh(self, result: RefreshResult) -> None:
        """Stage the selection into the sampler's back buffer."""
        sel, pool_idx, times = result.value
        self.sampler.stage(
            np.asarray(pool_idx)[np.asarray(sel.indices)],
            sel.weights,
            version=result.version,
            meta={
                "coreset_size": sel.size,
                "epsilon_hat": float(sel.epsilon_hat),
                "select_time_s": result.wall_time_s,
                **times,
                "per_class_sizes": sel.per_class_sizes,
                "engine": sel.engine,
                "dropped_rows": sel.n_dropped,
            },
        )

    def _refresh_failed(self, result: RefreshResult) -> None:
        """``on_exhaustion='keep_stale'``: log the abandoned refresh."""
        err = result.error
        self.metrics_log.append({
            "event": "craig_refresh_failed",
            "step": self.step,
            "version": result.version,
            "attempts": result.attempts,
            "error": f"{type(err).__name__}: {err}",
        })

    # -- streaming ingest ------------------------------------------------------

    def _stream_submit(self) -> None:
        """Refresh boundary in streaming mode: queue the docs the dataset
        grew by since the last boundary as one delta.  No new docs: a no-op,
        and training goes on with the installed coreset."""
        n = self.dataset.n_docs
        if n <= self._stream_cursor:
            return
        new_idx = np.arange(self._stream_cursor, n, dtype=np.int64)
        self._stream_cursor = n
        self.refresher.ingest((snapshot(self.params), new_idx))

    def _stream_ingest_job(self, deltas: list):
        """One coalesced drain (the refresher's worker thread in async
        mode): extract proxies for the new docs only, ingest them, evict
        dead pool rows, finalize.  Transactional: on a failure the selector,
        the pool and the doc ids stay as they were, so a retry replays the
        whole drain."""
        params = deltas[-1][0]  # the newest snapshot wins
        new_idx = np.concatenate([d[1] for d in deltas])  # cursor order
        t0 = time.perf_counter()
        feats = self.extractor.extract(params, new_idx)
        _sync(self.device)
        t1 = time.perf_counter()
        labels = self._pool_labels(new_idx)
        if self._stream_sel is None:
            k = max(1, int(round(self.tcfg.craig.fraction * new_idx.size)))
            self._stream_sel = StreamingSelector(
                k, feats.shape[1], metric=self.tcfg.craig.metric,
                per_class=labels is not None, evict=self.tcfg.streaming_evict,
                device=self.device,
            )
            self._stream_pool = feats.new_zeros((0, feats.shape[1]))
        sel = self._stream_sel
        snap = sel.snapshot()
        try:
            sel.ingest(feats, labels=labels)
            pool = torch.cat([self._stream_pool, feats])
            doc_ids = np.concatenate([self._stream_doc_ids, new_idx])
            if self.tcfg.streaming_evict:
                keep = sel.compact()
                pool = pool[torch.as_tensor(keep, device=pool.device)]
                doc_ids = doc_ids[keep]
            _sync(self.device)
            t2 = time.perf_counter()
            res = sel.result(pool)
            idx = res.indices.cpu().numpy()
            t3 = time.perf_counter()
        except BaseException:
            sel.restore(snap)
            raise
        self._stream_pool, self._stream_doc_ids = pool, doc_ids
        times = {"extract_time_s": t1 - t0, "ingest_time_s": t2 - t1,
                 "finalize_time_s": t3 - t2}
        return (doc_ids[idx], res.weights.cpu().numpy().astype(np.float32),
                float(res.coverage), sel.n_rows, times)

    def _publish_stream(self, result: RefreshResult) -> None:
        """Stage a drain's selection (doc ids, γ) into the sampler's back
        buffer, with the streaming provenance in its metadata."""
        doc_ids, weights, coverage, n_live, times = result.value
        self.sampler.stage(
            doc_ids,
            weights,
            version=result.version,
            meta={
                "coreset_size": int(doc_ids.size),
                "select_time_s": result.wall_time_s,
                **times,
                "coverage": coverage,
                "n_seen": self._stream_sel.n_seen,
                "n_live": n_live,
                "engine": self._stream_sel.config.to_dict(),
            },
        )

    def _install_refresh(self) -> None:
        """Epoch-boundary install: wait out an in-flight selection, then
        swap the staged coreset in."""
        t0 = time.time()
        self.refresher.wait()
        stall = time.time() - t0
        p = self.sampler.install_pending()
        if p is None:
            return
        meta = p.get("meta") or {}
        self.metrics_log.append({
            "event": "craig_refresh",
            "step": self.step,
            "version": p["version"],
            "mode": self.tcfg.refresh_mode,
            "coreset_size": len(p["indices"]),
            "weight_sum": float(np.sum(p["weights"], dtype=np.float64)),
            "epsilon_hat": meta.get("epsilon_hat", float("nan")),
            "select_time_s": meta.get("select_time_s", float("nan")),
            "extract_time_s": meta.get("extract_time_s", float("nan")),
            "selection_time_s": meta.get("selection_time_s", float("nan")),
            "install_stall_s": stall,
            "engine": meta.get("engine"),
            **{k: meta[k] for k in _STREAM_META if k in meta},
        })

    # -- evaluation ------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self) -> float:
        """Mean held-out loss over ``eval_batches`` deterministic batches."""
        ds = self.eval_dataset or self.dataset
        bs = self.tcfg.batch_size
        total = 0.0
        for b in range(self.tcfg.eval_batches):
            idx = (np.arange(bs) + b * bs) % ds.n_docs
            batch = to_device(ds.batch(idx), self.device)
            total += float(model_loss_fn(self.params, self.cfg, batch)[1]["loss"])
        loss = total / max(self.tcfg.eval_batches, 1)
        self.metrics_log.append({"event": "eval", "step": self.step, "eval_loss": loss})
        return loss

    # -- checkpoint -------------------------------------------------------------

    def _save(self, blocking: bool = True) -> None:
        if self.ckpt is None:
            return
        # an in-flight refresh materialises into the staged buffer first
        self.refresher.wait()
        prev = self._prev_selection
        extras = {
            "step": self.step,
            "sampler": self.sampler.state_dict(),
            "last_epoch_selected": self._last_epoch_selected,
            "prev_selection": None if prev is None else {
                "indices": np.asarray(prev.indices).tolist(),
                "weights": np.asarray(prev.weights).tolist(),
                "coverage": float(prev.coverage),
                "epsilon_hat": float(prev.epsilon_hat),
                "engine": prev.engine,
                "per_class_sizes": None if prev.per_class_sizes is None else
                {str(k): int(v) for k, v in prev.per_class_sizes.items()},
            },
        }
        tree = {"params": self.params, "opt": self.opt_state}
        if self.tcfg.streaming_ingest:
            # the pool and the sieve states go in the tensor tree, the rest
            # of the selector's state_dict in the JSON extras
            sel = self._stream_sel
            sd = None if sel is None else sel.state_dict(tensors=True)
            states = {} if sd is None else sd["states"]
            if sd is not None:
                sd["states"] = list(states)
            tree["stream"] = {
                "pool": torch.zeros(0) if self._stream_pool is None else self._stream_pool,
                "states": states,
            }
            extras["stream"] = {"cursor": self._stream_cursor, "selector": sd,
                                "doc_ids": self._stream_doc_ids.tolist()}
        self.ckpt.save(self.step, tree, extras, blocking=blocking)

    def restore_or_init(self, shardings: Any | None = None) -> bool:
        """Restore the latest checkpoint if there is one; True if restored.
        ``shardings`` places the restored parameters and optimizer state
        (``CheckpointManager.restore``): a tree ``{"params": ..., "opt":
        ...}`` of ``(DeviceMesh, placements)`` pairs, onto any mesh."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        template = {"params": self.params, "opt": self.opt_state}
        st = self.ckpt.extras().get("stream")
        if st is not None:
            keys = [] if st["selector"] is None else st["selector"]["states"]
            # None leaves: the saved tensors as written (dtypes included)
            template["stream"] = {
                "pool": None,
                "states": {k: dict.fromkeys(StreamingState._fields) for k in keys},
            }
        tree, extras = self.ckpt.restore(template, shardings=shardings)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.step = int(extras["step"])
        self.sampler.load_state_dict(extras["sampler"])
        self._last_epoch_selected = int(extras["last_epoch_selected"])
        self.refresher.reset_version(
            max(self.sampler.version, self.sampler.pending_version or 0)
        )
        ps = extras.get("prev_selection")
        if ps is not None:
            pcs = ps.get("per_class_sizes")
            self._prev_selection = CoresetSelection(
                indices=np.asarray(ps["indices"], np.int64),
                weights=np.asarray(ps["weights"], np.float32),
                order=np.arange(len(ps["indices"])),
                coverage=float(ps["coverage"]),
                epsilon_hat=float(ps["epsilon_hat"]),
                per_class_sizes=None if pcs is None else {int(k): int(v) for k, v in pcs.items()},
                engine=ps.get("engine"),
            )
        if st is not None:
            self._stream_cursor = int(st["cursor"])
            self._stream_doc_ids = np.asarray(st["doc_ids"], np.int64)
            sd = st["selector"]
            if sd is not None:
                sd["states"] = tree["stream"]["states"]
                self._stream_sel = StreamingSelector(sd["budget"], sd["dim"], device=self.device)
                self._stream_sel.load_state_dict(sd)
                self._stream_pool = tree["stream"]["pool"].to(self.device)
        return True

    # -- main loop ----------------------------------------------------------------

    def run(self, n_steps: int) -> list[dict]:
        tc = self.tcfg
        for _ in range(n_steps):
            epoch = self.sampler.epoch
            # install the previous trigger's selection at this epoch
            # boundary, then (on cadence) snapshot params and start the next
            if tc.use_craig and tc.select_every_epochs > 0 and self.sampler.step_in_epoch == 0:
                self._install_refresh()
                if epoch % tc.select_every_epochs == 0 and epoch != self._last_epoch_selected:
                    if tc.streaming_ingest:
                        self._stream_submit()
                    else:
                        self.refresher.submit(self.params)
                    self._last_epoch_selected = epoch

            idx, w = self.sampler.next_batch()
            batch = self.dataset.batch(idx)
            batch["weights"] = w
            batch.pop("indices", None)
            batch = to_device(batch, self.device)
            t0 = time.time()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            if tc.step_timeout_s is not None and dt > tc.step_timeout_s:
                self.straggler_events.append(self.step)
            self.step += 1
            self.metrics_log.append(
                {"event": "step", "step": self.step, "loss": loss, "epoch": epoch, "time_s": dt}
            )
            if tc.eval_every and self.step % tc.eval_every == 0:
                self.evaluate()
            if self.ckpt is not None and self.step % tc.checkpoint_every == 0:
                self._save(blocking=False)
            if self._preempt:
                self._save(blocking=True)
                break
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.metrics_log
