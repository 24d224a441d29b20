"""LM training with CRAIG per-epoch coreset selection, on the card.

Port of ``examples/lm_coreset_training.py``.  Trains a decoder-only
transformer on the seeded topic-structured token stream, re-selecting a
weighted coreset from pooled unembed-input gradient proxies (paper §3.4)
every epoch; on a card the proxies go through the hand-written
``ce_proxy`` kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_coreset_training \\
          [--steps 300] [--d-model 256] [--layers 8] [--no-craig]
      PYTHONPATH=src python -m repro_torch.examples.lm_coreset_training \\
          --config qwen3-1.7b --seq 512 --steps 84
      PYTHONPATH=src python -m repro_torch.examples.lm_coreset_training --device cpu \\
          --d-model 64 --layers 2 --vocab 256 --seq 16 --docs 32 --steps 8

``--config NAME`` takes a registered model at its published width (its
vocabulary replaces ``--vocab``; ``--layers`` still cuts depth when
given).  ``--ckpt DIR`` checkpoints there and resumes from it; without it
nothing is written.  fp32 matrix products run in full fp32 (TF32 off).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.craig import CraigConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import ModelConfig, init_params
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig


def model_config(args) -> ModelConfig:
    if args.config:
        cfg = get_config(args.config)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        return cfg
    d = args.d_model
    return ModelConfig(
        name="example-lm",
        family="dense",
        n_layers=args.layers or 8,
        d_model=d,
        n_heads=max(4, d // 64),
        n_kv_heads=max(2, d // 128),
        d_ff=d * 4,
        vocab_size=args.vocab,
        logit_chunk=64,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--config", default=None, help="registered model, e.g. qwen3-1.7b")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--docs", type=int, default=512)
    ap.add_argument("--fraction", type=float, default=0.3)
    ap.add_argument("--no-craig", action="store_true")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (none by default)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config(args)
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}, vocab {cfg.vocab_size}; device {device}")

    ds = TokenStream(n_docs=args.docs, seq_len=args.seq, vocab_size=cfg.vocab_size,
                     n_topics=16)
    tcfg = TrainerConfig(
        batch_size=args.batch,
        select_every_epochs=0 if args.no_craig else 1,
        use_craig=not args.no_craig,
        craig=CraigConfig(fraction=args.fraction, per_class=False),
        proxy_pool_batches=args.docs // args.batch,
        checkpoint_dir=args.ckpt,
        checkpoint_every=100,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    trainer = Trainer(
        cfg, tcfg, ds, adamw(warmup_cosine(3e-4, 50, args.steps)),
        lambda: init_params(cfg, gen), device=device,
    )
    trainer.install_signal_handler()
    if trainer.restore_or_init():
        print(f"restored from checkpoint at step {trainer.step}")

    t0 = time.time()
    log = trainer.run(args.steps)
    trainer.refresher.wait()
    dt = time.time() - t0

    steps = [m for m in log if m["event"] == "step"]
    refreshes = [m for m in log if m["event"] == "craig_refresh"]
    first = np.mean([s["loss"] for s in steps[:10]])
    last = np.mean([s["loss"] for s in steps[-10:]])
    print(f"\n{len(steps)} steps in {dt:.1f}s ({dt / max(len(steps), 1) * 1e3:.0f} ms/step)")
    print(f"loss: {first:.3f} → {last:.3f}")
    if refreshes:
        sel_t = sum(r["select_time_s"] for r in refreshes)
        print(f"CRAIG: {len(refreshes)} refreshes, coreset "
              f"{refreshes[-1]['coreset_size']}/{args.docs} docs, "
              f"selection overhead {sel_t / dt * 100:.1f}% of wall time, "
              f"ε̂={refreshes[-1]['epsilon_hat']:.3f}")
    print(f"distinct data touched: {trainer.sampler.active_size}/{args.docs} docs per epoch")
    return {"first_loss": float(first), "last_loss": float(last),
            "steps": len(steps), "refreshes": len(refreshes)}


if __name__ == "__main__":
    main()
