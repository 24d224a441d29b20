"""Decoder-only LM: parameters, forward, γ-weighted chunked CE, CRAIG
proxies, prefill and one-token decode.

Port of ``repro.models.model``:

* ``init_params(cfg, generator)`` — fp32 master weights, on the
  generator's device;
* ``param_shapes(cfg)`` — every parameter's name and shape;
* ``forward(params, cfg, batch)`` — hidden states (B, T, D) after the final
  norm, in ``COMPUTE_DTYPE``, and the MoE auxiliary loss summed over
  layers (0 for dense layers);
* ``loss_fn(params, cfg, batch)`` — γ-weighted mean CE:
  Σ_b per_example_b·w_b / max(Σw, 1e-6), per-example weights = the
  paper's per-element stepsizes (Eq. 20);
* ``proxy_features`` (chunked einsum path) and ``proxy_features_fused``
  (the ``ce_proxy`` kernel) — pooled unembed-input gradient proxies (B, D);
* ``init_serve_state(cfg, batch, max_len, device)`` — per-layer decode
  states (bf16 KV caches, Griffin states) and the position ``pos``, a
  host integer, so the ring slot of a windowed cache needs no device
  read;
* ``prefill(params, cfg, batch)`` — hidden states and the last token's
  fp32 logits (B, padded_vocab) from a bf16 product.  It does not fill
  the caches, nor does the reference's: generation teacher-forces the
  prompt through ``decode_step``;
* ``decode_step(params, cfg, state, batch)`` — one token (B, 1) → fp32
  logits (B, padded_vocab) and the state at ``pos + 1``.  KV caches are
  written in place; the returned state holds the same tensors.

Parameters are one flat dict of fp32 tensors: ``embed`` (padded_vocab, d),
``layers.<i>.*`` (see ``blocks.py``), ``final_norm.scale`` (d,) and
``unembed`` (padded_vocab, d).  The unembedding is stored vocab-major —
the transpose of the reference's (d, padded_vocab) — so a vocab block is
one contiguous slab for the kernel; with tied embeddings it is ``embed``
itself.  Casts to ``COMPUTE_DTYPE`` (bf16) happen where the reference
makes them: the embedded input, each weight at its matrix product, and
the logits' matrix products.

Batch dict: ``tokens`` (B, T) and ``labels`` (B, T) integer tensors,
optional ``positions`` (B, T) and ``weights`` (B,) fp32.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models.blocks import (init_decode_state, init_stack, norm_fn, stack_decode,
                                       stack_forward)
from repro_torch.models.config import ModelConfig, require_ported
from repro_torch.models.layers import dense_init

__all__ = [
    "COMPUTE_DTYPE",
    "init_params",
    "param_shapes",
    "unembed_matrix",
    "forward",
    "loss_fn",
    "proxy_features",
    "proxy_features_fused",
    "init_serve_state",
    "prefill",
    "decode_step",
]

COMPUTE_DTYPE = torch.bfloat16


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """fp32 master weights on ``generator.device`` (truncated normal,
    1/√fan_in; the embedding and the vocab-major unembedding scale by
    1/√d_model like the reference's)."""
    return _init(cfg, generator, generator.device)


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, from an init on the meta device."""
    return {k: tuple(v.shape) for k, v in _init(cfg, None, torch.device("meta")).items()}


def _init(cfg: ModelConfig, generator, device) -> dict:
    require_ported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    p = init_stack(cfg, generator, device)
    p["embed"] = dense_init((vp, d), generator, device, fan=d)
    p["final_norm.scale"] = torch.ones((d,), device=device)
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((vp, d), generator, device, fan=d)
    return p


def unembed_matrix(params: dict) -> torch.Tensor:
    """The (padded_vocab, d) unembedding (``embed`` when tied)."""
    return params["unembed"] if "unembed" in params else params["embed"]


def _positions(batch: dict) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    B, T = batch["tokens"].shape
    return torch.arange(T, device=batch["tokens"].device).expand(B, T)


def forward(params: dict, cfg: ModelConfig, batch: dict):
    """Returns (hidden (B, T, D) post-final-norm in COMPUTE_DTYPE, aux)."""
    require_ported(cfg)
    x = params["embed"][batch["tokens"].long()].to(COMPUTE_DTYPE)
    x, aux = stack_forward(params, cfg, x, _positions(batch))
    x = norm_fn(cfg)(params["final_norm.scale"], x, cfg.norm_eps)
    return x, aux


def _ce_chunk(h_c, unembed, y_c, valid_v):
    logits = (h_c.to(COMPUTE_DTYPE) @ unembed.to(COMPUTE_DTYPE).T).float()
    V = logits.shape[-1]
    if valid_v is not None and valid_v < V:
        pad = torch.where(torch.arange(V, device=logits.device) < valid_v, 0.0, -1e30)
        logits = logits + pad
    lse = torch.logsumexp(logits, dim=-1)
    ok = (y_c >= 0) & (y_c < V)  # a label outside the vocab has no gold logit
    gold = torch.gather(logits, -1, torch.where(ok, y_c, 0).long()[..., None])[..., 0]
    return lse - torch.where(ok, gold, 0.0)


def _chunked_ce(hidden, unembed, labels, chunk: int, valid_v: int | None = None):
    """Per-token CE (B, T) fp32, over sequence chunks of ``chunk`` tokens
    (one chunk when ``chunk`` does not divide T).  Each chunk's (B, chunk,
    V) logits are recomputed in the backward rather than kept."""
    B, T, D = hidden.shape
    if T % chunk != 0 or T < chunk:
        chunk = T
    out = []
    for lo in range(0, T, chunk):
        h_c, y_c = hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            out.append(checkpoint(_ce_chunk, h_c, unembed, y_c, valid_v, use_reentrant=False))
        else:
            out.append(_ce_chunk(h_c, unembed, y_c, valid_v))
    return torch.cat(out, dim=1)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    """Weighted mean CE → (total, metrics).  CRAIG's γ enter as
    per-example loss weights."""
    hidden, aux = forward(params, cfg, batch)
    B = hidden.shape[0]
    w = batch.get("weights")
    if w is None:
        w = torch.ones((B,), device=hidden.device)
    per_tok = _chunked_ce(
        hidden, unembed_matrix(params), batch["labels"], cfg.logit_chunk,
        valid_v=cfg.vocab_size,
    )
    per_example = torch.mean(per_tok, dim=-1)
    denom = torch.clamp(torch.sum(w), min=1e-6)
    loss = torch.sum(per_example * w) / denom
    total = loss + 1e-2 * aux
    return total, {"loss": loss, "aux_loss": aux, "per_example_loss": per_example}


@torch.no_grad()
def proxy_features(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Pooled unembed-input gradient proxies (B, D) fp32 through the
    chunked einsum path (``core.proxy.lm_unembed_input_proxy``)."""
    from repro_torch.core.proxy import lm_unembed_input_proxy

    hidden, _ = forward(params, cfg, batch)
    return lm_unembed_input_proxy(
        hidden, unembed_matrix(params), batch["labels"], chunk=cfg.logit_chunk,
        valid_v=cfg.vocab_size, compute_dtype=COMPUTE_DTYPE,
    )


@torch.no_grad()
def proxy_features_fused(
    params: dict,
    cfg: ModelConfig,
    batch: dict,
    *,
    compute_dtype: torch.dtype = COMPUTE_DTYPE,
    impl: str = "auto",
) -> torch.Tensor:
    """Pooled unembed-input proxies (B, D) fp32 through ``ops.ce_proxy``.

    Same contract as :func:`proxy_features`; all sequences share one
    token stream (per-token gradients are independent), so (B, T)
    flattens to B·T tokens for the kernel and pools back per sequence.
    ``impl`` is the kernel dispatch ('auto' → the CUDA kernel for tensors
    on a card, the plain twin on the CPU).
    """
    from repro_torch.kernels import ops

    hidden, _ = forward(params, cfg, batch)
    B, T, D = hidden.shape
    g = ops.ce_proxy(
        hidden.reshape(B * T, D), unembed_matrix(params),
        batch["labels"].reshape(B * T), valid_v=cfg.vocab_size,
        compute_dtype=compute_dtype, impl=impl,
    )
    return torch.mean(g.reshape(B, T, D), dim=1)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     device: str | torch.device = "cuda") -> dict:
    """Decode states for every layer and the position counter (0)."""
    dev = resolve_device(device)
    return {"layers": init_decode_state(cfg, batch, max_len, dev), "pos": 0}


def _logits(params: dict, last: torch.Tensor) -> torch.Tensor:
    """(B, D) → fp32 logits (B, padded_vocab) from a COMPUTE_DTYPE product."""
    return (last.to(COMPUTE_DTYPE) @ unembed_matrix(params).to(COMPUTE_DTYPE).T).float()


def prefill(params: dict, cfg: ModelConfig, batch: dict):
    """Forward over the prompt → (hidden (B, T, D), last-token logits (B, V))."""
    hidden, _ = forward(params, cfg, batch)
    return hidden, _logits(params, hidden[:, -1])


def decode_step(params: dict, cfg: ModelConfig, state: dict, batch: dict):
    """One token ``batch['tokens']`` (B, 1) at ``state['pos']`` →
    (logits (B, padded_vocab) fp32, state at pos + 1)."""
    x = params["embed"][batch["tokens"].long()].to(COMPUTE_DTYPE)
    pos = state["pos"]
    x, layers = stack_decode(params, cfg, state["layers"], x, pos)
    x = norm_fn(cfg)(params["final_norm.scale"], x, cfg.norm_eps)
    return _logits(params, x[:, 0]), {"layers": layers, "pos": pos + 1}
