"""Serving: batched prefill and one-token decode steps.

Port of ``repro.serve.serve_step``:

* ``make_prefill_step(cfg)`` — forward over the whole prompt, the
  last token's logits;
* ``make_serve_step(cfg)`` — one new token against the KV caches and
  recurrent states (``models.decode_step``); caches are written in place;
* ``greedy_generate`` — the host loop driving the serve step: the prompt
  teacher-forced through the decode path (which fills the caches), then
  ``max_new`` greedy tokens (argmax over the padded vocabulary, the first
  of equal maxima, as ``jnp.argmax``).  It runs under
  ``torch.inference_mode()`` on the prompt's device.

The serving shapes of ``configs/shapes.py`` (``prefill_32k``,
``decode_32k`` at batch 128, ``long_500k`` from a 524,288-deep state) are
reckoned — memory, FLOPs, bytes, roofline bound — on fake tensors by
``launch/dryrun.py``, whether or not one card holds them.

On a mesh both steps run on DTensor parameters placed by
``distributed.sharding.serve_param_specs`` (tensor parallelism, no
ZeRO-3) and a state whose tensors ``serve_state_specs`` places (the KV
caches and recurrent states; ``pos`` stays a host integer), in
``train.train_step.on_mesh``'s context.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import decode_step, init_serve_state, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.train.train_step import on_mesh

__all__ = ["make_prefill_step", "make_serve_step", "greedy_generate"]


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        with on_mesh(params):
            _, logits = prefill(params, cfg, batch)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, state, batch):
        with on_mesh(params):
            return decode_step(params, cfg, state, batch)

    return serve_step


@torch.inference_mode()
def greedy_generate(params: dict, cfg: ModelConfig, prompt_tokens: torch.Tensor,
                    max_new: int, max_len: int | None = None) -> torch.Tensor:
    """Greedy decoding of (B, T) prompts → (B, T + max_new) tokens in the
    prompt's dtype, on its device."""
    B, T = prompt_tokens.shape
    state = init_serve_state(cfg, B, max_len or (T + max_new), prompt_tokens.device)
    step = make_serve_step(cfg)
    logits = None
    for t in range(T):  # teacher-force the prompt (builds the caches)
        logits, state = step(params, state, {"tokens": prompt_tokens[:, t:t + 1]})
    out = [prompt_tokens]
    cur = torch.argmax(logits, dim=-1, keepdim=True).to(prompt_tokens.dtype)
    for _ in range(max_new):
        out.append(cur)
        logits, state = step(params, state, {"tokens": cur})
        cur = torch.argmax(logits, dim=-1, keepdim=True).to(prompt_tokens.dtype)
    return torch.cat(out, dim=1)
