"""Training launcher: CRAIG LM training of a registered architecture.

Port of ``repro.launch.train`` (single device):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b \\
        --smoke --device cpu --steps 12

``--smoke`` takes the reduced same-family config (``configs.smoke_config``);
without it the published config runs.  As in the reference, an
architecture with a stub modality frontend (qwen2-vl-7b) trains its
backbone on the synthetic token stream with the token frontend.  A
config with codebook heads (musicgen-medium) raises ``ValueError``: the
stream yields one label a token, the heads need one a codebook (the
reference's launcher fails there too); drive it through the model's
entry points (``models``, ``train.make_train_step``).

Wired in as in the reference: CRAIG per-epoch coreset refresh
(``--craig-fraction``, ``--select-every``), micro-batched gradient
accumulation, checkpoint/restart (``--ckpt``) and SIGTERM → emergency
save.  The trainer runs on ``--device`` (default
``cuda``; ``cpu`` on request); on a card the refresh's proxies go through
the ``ce_proxy`` kernel.  Like the reference's launcher, this one trains
on one device: the reference's docstring names a multi-host mesh its
launcher does not build.  Model parallelism is in the steps
(``train.make_train_step`` on DTensor parameters placed by
``distributed.sharding``; ``tests/torch_mesh_worker.py`` drives it over
gloo), and distributed *selection* in ``launch.tree``.  The reference's
docstring names a ``--dry-run`` flag
its launcher does not have; its dry run is ``launch/dryrun.py``, and so is
the port's (``python -m repro_torch.launch.dryrun``: every arch × shape
cell reckoned on fake tensors, of one H100 or per device of the
production meshes, ``roofline.py`` on top).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.craig import CraigConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import init_params
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--craig-fraction", type=float, default=0.5)
    ap.add_argument("--no-craig", action="store_true")
    ap.add_argument("--select-every", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def launch_config(arch: str, smoke: bool):
    """The config the token-stream launchers run: a stub modality frontend
    swapped to tokens (the backbone is unchanged, the modality stub is
    data-side), as the reference's launchers do; codebook heads refused."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.n_codebooks > 1:
        raise ValueError(
            f"{cfg.name}: {cfg.n_codebooks} codebook heads need (B, T, {cfg.n_codebooks}) "
            "labels and feed back (B, n_codebooks) tokens, but the token-stream launchers "
            "yield (B, T) labels and (B, 1) tokens (the reference's launchers fail here "
            "too: a reshape TypeError in its codebook loss, an einsum ValueError in its "
            "greedy_generate); drive it through the model's entry points instead")
    if cfg.frontend != "tokens":
        cfg = dataclasses.replace(cfg, frontend="tokens")
    return cfg


def main(argv=None) -> dict:
    """Run training; returns the step losses and the number of CRAIG
    selections run."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = launch_config(args.arch, args.smoke)
    print(f"arch={cfg.name} ({'smoke' if args.smoke else 'full'}) "
          f"params≈{cfg.param_count()/1e6:.1f}M layers={cfg.n_layers} device={device}")

    ds = TokenStream(n_docs=args.docs, seq_len=args.seq,
                     vocab_size=cfg.vocab_size, n_topics=16)
    tcfg = TrainerConfig(
        batch_size=args.batch,
        select_every_epochs=0 if args.no_craig else args.select_every,
        use_craig=not args.no_craig,
        craig=CraigConfig(fraction=args.craig_fraction, per_class=False),
        proxy_pool_batches=max(1, args.docs // args.batch),
        checkpoint_dir=args.ckpt,
        microbatches=args.microbatches,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    trainer = Trainer(
        cfg, tcfg, ds, adamw(warmup_cosine(args.lr, 10, args.steps)),
        lambda: init_params(cfg, gen), device=device,
    )
    trainer.install_signal_handler()
    if trainer.restore_or_init():
        print(f"restored at step {trainer.step}")
    t0 = time.time()
    log = trainer.run(args.steps)
    trainer.refresher.wait()
    steps = [m for m in log if m["event"] == "step"]
    losses = [m["loss"] for m in steps]
    if steps:
        print(f"{len(steps)} steps in {time.time()-t0:.1f}s; "
              f"loss {losses[0]:.3f} → {np.mean(losses[-5:]):.3f}")
    return {"losses": losses, "selections": trainer.refresher.version}


if __name__ == "__main__":
    main()
