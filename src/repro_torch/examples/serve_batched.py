"""Batched serving example: KV-cache greedy decoding, on the card.

Port of ``examples/serve_batched.py``.  Initializes a small seeded model,
teacher-forces a batch of prompts through the decode path and generates
continuations with the one-token serve step, then generates again and
asserts that the tokens repeat.  ``--window`` selects the hybrid model
(RG-LRU and sliding-window attention layers) with that window.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--batch 4] [--new 32]
      PYTHONPATH=src python -m repro_torch.examples.serve_batched --window 8 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.models import ModelConfig, init_params
from repro_torch.serve import greedy_generate


def demo_config(window: int) -> ModelConfig:
    """The reference example's model: 4 layers of d 128, global attention,
    or (rglru, local_attn) periods with a window."""
    return ModelConfig(
        name="serve-demo",
        family="hybrid" if window else "dense",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=4096,
        window=window or None,
        block_pattern=("rglru", "local_attn") if window else ("attn",),
        d_rnn=128 if window else 0,
        logit_chunk=64,
    )


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention (0 = global)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = demo_config(args.window)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({'local window ' + str(args.window) if args.window else 'global attention'}) "
          f"on {device}")

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(device)
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompts, max_new=args.new).cpu()
    dt = time.perf_counter() - t0
    toks = args.batch * (args.prompt_len + args.new)
    print(f"generated {args.batch}×{args.new} tokens in {dt:.2f}s "
          f"({toks / dt:.0f} tok/s incl. the prompt)")
    for b in range(min(args.batch, 2)):
        seq = out[b].tolist()
        print(f"  req{b}: …{seq[args.prompt_len - 4:args.prompt_len]}"
              f" → {seq[args.prompt_len:args.prompt_len + 12]}…")
    out2 = greedy_generate(params, cfg, prompts, max_new=args.new).cpu()
    if not torch.equal(out, out2):
        raise AssertionError("greedy decoding did not repeat token for token")
    print("deterministic: ✓")
    return out


if __name__ == "__main__":
    main()
