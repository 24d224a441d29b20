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
  states (bf16 KV caches, Griffin and xLSTM states) and the position
  ``pos``, a host integer, so the ring slot of a windowed cache needs no
  device read;
* ``prefill(params, cfg, batch)`` — hidden states and the last token's
  fp32 logits (B, padded_vocab), or (B, n_codebooks, padded_vocab), from
  a bf16 product.  It does not fill the caches, nor does the reference's:
  generation teacher-forces the prompt through ``decode_step``;
* ``decode_step(params, cfg, state, batch)`` — one step, ``{'tokens': (B,
  1)}`` or ``{'embeddings': (B, 1, D)}`` → fp32 logits as ``prefill``'s
  and the state at ``pos + 1``.  KV caches are written in place; the
  returned state holds the same tensors.

Parameters are one flat dict of fp32 tensors: ``embed`` (padded_vocab, d)
with the token frontend (none with the embeddings frontend),
``layers.<i>.*`` (see ``blocks.py``), ``final_norm.scale`` (d,) and
``unembed`` (padded_vocab, d), or (n_codebooks, padded_vocab, d) with
codebook heads.  The unembedding is stored vocab-major — the transpose of
the reference's (d, padded_vocab) — so a vocab block is one contiguous
slab for the kernel, and each codebook's head a slab of its own; with
tied embeddings it is ``embed`` itself.  Casts to ``COMPUTE_DTYPE``
(bf16) happen where the reference makes them: the embedded input, each
weight at its matrix product, and the logits' matrix products.

Batch dict (the reference's ``train_batch_struct`` layout):
  tokens      (B, T) integer            [frontend 'tokens']
  embeddings  (B, T, D), cast to bf16   [frontend 'embeddings': the
              modality frontend is a stub, these are its outputs]
  labels      (B, T), or (B, T, n_codebooks) with codebook heads
  positions   optional (B, T), or (B, 3, T) under M-RoPE (default: 0…T−1,
              the three streams equal)
  weights     optional (B,) fp32 — CRAIG γ (default 1)
With codebook heads the per-token CE, both proxies and the logits are
taken per codebook; the loss and the proxies average over codebooks.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.distributed.annotate import constrain, unsharded
from repro_torch.models.blocks import (init_decode_state, init_stack, norm_fn, stack_decode,
                                       stack_forward)
from repro_torch.models.config import ModelConfig, validate_config
from repro_torch.models.layers import dense_init

__all__ = [
    "COMPUTE_DTYPE",
    "init_params",
    "param_shapes",
    "stored_param_count",
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


def stored_param_count(cfg: ModelConfig) -> int:
    """The element count of the tables ``init_params`` allocates, from the
    config alone.  ``param_count()`` (the reference's) counts every
    vocabulary table at the real vocabulary, a tied unembedding too; the
    port stores each at ``padded_vocab`` rows, a tied one once.  It also
    leaves out each RG-LRU layer's Λ and gate biases and each xLSTM cell's
    convolution, gate biases, skip and output-norm scales, and counts a
    second pre-norm an xLSTM layer lacks."""
    d, di = cfg.d_model, cfg.n_heads * cfg.head_dim
    tokens = cfg.frontend == "tokens"
    counted = tokens + cfg.n_codebooks
    stored = tokens + (0 if tokens and cfg.tie_embeddings else cfg.n_codebooks)
    extra = {"rglru": 3 * (cfg.d_rnn or d),
             "mlstm": cfg.conv_width * di + 2 * cfg.n_heads + 2 * di - d,
             "slstm": 5 * di - d}
    return (cfg.param_count() + (stored * cfg.padded_vocab - counted * cfg.vocab_size) * d
            + sum(extra.get(k, 0) for k in cfg.layer_kinds))


def _init(cfg: ModelConfig, generator, device) -> dict:
    validate_config(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    p = init_stack(cfg, generator, device)
    if cfg.frontend == "tokens":
        p["embed"] = dense_init((vp, d), generator, device, fan=d)
    p["final_norm.scale"] = torch.ones((d,), device=device)
    if cfg.n_codebooks > 1:
        p["unembed"] = torch.stack([dense_init((vp, d), generator, device, fan=d)
                                    for _ in range(cfg.n_codebooks)])
    elif not (cfg.tie_embeddings and cfg.frontend == "tokens"):
        p["unembed"] = dense_init((vp, d), generator, device, fan=d)
    return p


def unembed_matrix(params: dict) -> torch.Tensor:
    """The (padded_vocab, d) unembedding (``embed`` when tied), or the
    (n_codebooks, padded_vocab, d) codebook heads."""
    return params["unembed"] if "unembed" in params else params["embed"]


def _embed_input(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if cfg.frontend == "tokens":
        # on a mesh the table gathered over data for the lookup (ZeRO-3)
        x = _lookup(unsharded({"embed": params["embed"]})["embed"], batch["tokens"].long())
    else:
        x = batch["embeddings"]  # the stub frontend's outputs
    return constrain(x.to(COMPUTE_DTYPE), "batch", None, None)


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a mesh each device looks up its own tokens in
    its slice of the table (``local_map``): the tokens keep their batch
    split, the table its split of d_model where the tokens are whole, and
    the table's gradient is a partial sum over the devices that split the
    batch (some PyTorch releases have no sharding strategy for an index
    into a split table)."""
    if not isinstance(table, DTensor):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = [p if p == Shard(0) else Replicate() for p in tokens.placements]
    cols = [Shard(1) if q == Shard(1) and p != Shard(0) else Replicate()
            for p, q in zip(rows, table.placements)]
    out = [Shard(0) if p == Shard(0) else (Shard(2) if q == Shard(1) else Replicate())
           for p, q in zip(rows, cols)]
    grads = [Partial() if p == Shard(0) else q for p, q in zip(rows, cols)]
    return local_map(lambda t, i: t[i], out_placements=out, in_placements=(cols, rows),
                     in_grad_placements=(grads, rows), device_mesh=table.device_mesh,
                     redistribute_inputs=True)(table, tokens)


def _positions(cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    ref = batch["tokens"] if cfg.frontend == "tokens" else batch["embeddings"]
    B, T = ref.shape[:2]
    pos = torch.arange(T, device=ref.device).expand(B, T)
    if cfg.mrope_sections is not None:
        pos = pos[:, None].expand(B, 3, T)
    return pos


def _codebooks(cfg: ModelConfig, unembed: torch.Tensor, labels: torch.Tensor):
    """(head (V, D), labels (B, T)) per output head."""
    if cfg.n_codebooks > 1:
        return [(unembed[c], labels[..., c]) for c in range(cfg.n_codebooks)]
    return [(unembed, labels)]


def _codebook_mean(terms: list) -> torch.Tensor:
    """The reference's running sum over codebooks, over their count (one
    head: the term itself)."""
    if len(terms) == 1:
        return terms[0]
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total / len(terms)


def forward(params: dict, cfg: ModelConfig, batch: dict):
    """Returns (hidden (B, T, D) post-final-norm in COMPUTE_DTYPE, aux)."""
    validate_config(cfg)
    x = _embed_input(params, cfg, batch)
    x, aux = stack_forward(params, cfg, x, _positions(cfg, batch))
    x = norm_fn(cfg)(params["final_norm.scale"], x, cfg.norm_eps)
    # on a mesh the heads take whole rows: a sequence split left by the last
    # layer's reduction would reach the head's reshapes as a strided split
    return constrain(x, "batch", None, None), aux


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim as ATen composes it (max, exp
    of the difference, sum, log, plus the max) and its backward as ATen's
    (g·exp(x − lse)), in ops a DTensor splits along the vocab: DTensor's
    own logsumexp gathers the batch of a vocab-split operand."""

    @staticmethod
    def forward(ctx, x):
        m = torch.amax(x, dim=-1)
        lse = torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1)) + m
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None])


def _ce_chunk(h_c, unembed, y_c, valid_v):
    unembed = unsharded({"unembed": unembed})["unembed"]
    logits = (h_c.to(COMPUTE_DTYPE) @ unembed.to(COMPUTE_DTYPE).T).float()
    logits = constrain(logits, "batch", None, "tp")
    V = logits.shape[-1]
    vocab = torch.arange(V, device=logits.device)
    if valid_v is not None and valid_v < V:
        pad = torch.where(vocab < valid_v, 0.0, -1e30)
        logits = logits + pad
    if isinstance(logits, DTensor):
        # on a mesh, logsumexp in ops that split along the vocab, and the
        # gold logit by a one-hot reduce, as the reference takes it: a
        # gather along the model-split vocab has no sharding strategy.  One
        # nonzero term a row, so the sum is the gold logit (none for a
        # label outside the vocab).  Plain tensors keep ATen's fused
        # logsumexp and a gather, to the same values: a chunk of them runs
        # faster on the card (``chip_variants.py --ce-probe``).
        hit = vocab == y_c.long()[..., None]
        return _LogSumExp.apply(logits) - torch.sum(torch.where(hit, logits, 0.0), dim=-1)
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
    per_tok = _codebook_mean([
        _chunked_ce(hidden, head, y, cfg.logit_chunk, valid_v=cfg.vocab_size)
        for head, y in _codebooks(cfg, unembed_matrix(params), batch["labels"])])
    per_example = torch.mean(per_tok, dim=-1)
    denom = torch.clamp(torch.sum(w), min=1e-6)
    loss = torch.sum(per_example * w) / denom
    total = loss + 1e-2 * aux
    return total, {"loss": loss, "aux_loss": aux, "per_example_loss": per_example}


@torch.no_grad()
def proxy_features(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Pooled unembed-input gradient proxies (B, D) fp32 through the
    chunked einsum path (``core.proxy.lm_unembed_input_proxy``), averaged
    over codebooks."""
    from repro_torch.core.proxy import lm_unembed_input_proxy

    hidden, _ = forward(params, cfg, batch)
    return _codebook_mean([
        lm_unembed_input_proxy(hidden, head, y, chunk=cfg.logit_chunk, valid_v=cfg.vocab_size,
                               compute_dtype=COMPUTE_DTYPE)
        for head, y in _codebooks(cfg, unembed_matrix(params), batch["labels"])])


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
    One launch a codebook, each on its head's contiguous (V, D) slab.
    ``impl`` is the kernel dispatch ('auto' → the CUDA kernel for tensors
    on a card, the plain twin on the CPU).
    """
    from repro_torch.kernels import ops

    hidden, _ = forward(params, cfg, batch)
    B, T, D = hidden.shape
    flat = hidden.reshape(B * T, D)

    def one(head, y):
        g = ops.ce_proxy(flat, head, y.reshape(B * T), valid_v=cfg.vocab_size,
                         compute_dtype=compute_dtype, impl=impl)
        if isinstance(g, DTensor) and g.placements != flat.placements:
            # the op's rule may split the tokens further than the rows were
            # (over every mesh dim): back to the rows' split for the pooling
            g = g.redistribute(g.device_mesh, flat.placements)
        return torch.mean(g.reshape(B, T, D), dim=1)

    return _codebook_mean([one(head, y) for head, y in
                           _codebooks(cfg, unembed_matrix(params), batch["labels"])])


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     device: str | torch.device = "cuda", mesh=None) -> dict:
    """Decode states for every layer and the position counter (0).  With a
    ``DeviceMesh`` each tensor is a DTensor placed by
    ``distributed.sharding.serve_state_specs`` (the KV caches and the
    recurrent states); ``pos`` stays a host integer."""
    dev = resolve_device(device)
    layers = init_decode_state(cfg, batch, max_len, dev)
    if mesh is not None:
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.distributed.sharding import serve_state_specs, to_placements

        specs = serve_state_specs(layers, mesh, batch)
        layers = [{k: distribute_tensor(t, mesh, to_placements(specs[i][k], mesh),
                                        src_data_rank=None) for k, t in layer.items()}
                  for i, layer in enumerate(layers)]
    return {"layers": layers, "pos": 0}


def _logits(params: dict, last: torch.Tensor) -> torch.Tensor:
    """(B, D) → fp32 logits (B, padded_vocab), or (B, C, padded_vocab) with
    codebook heads, from a COMPUTE_DTYPE product."""
    w = unembed_matrix(params).to(COMPUTE_DTYPE)
    h = last.to(COMPUTE_DTYPE)
    if w.dim() == 3 and isinstance(h, DTensor):
        # on a mesh one head at a time: the einsum would merge the codebook
        # dim with the split vocab into a strided split
        return torch.stack([h @ w[c].T for c in range(w.shape[0])], dim=1).float()
    if w.dim() == 3:
        return torch.einsum("bd,cvd->bcv", h, w).float()
    return (h @ w.T).float()


def prefill(params: dict, cfg: ModelConfig, batch: dict):
    """Forward over the prompt → (hidden (B, T, D), last-token logits (B, V)
    or (B, C, V))."""
    hidden, _ = forward(params, cfg, batch)
    return hidden, _logits(params, hidden[:, -1])


def decode_step(params: dict, cfg: ModelConfig, state: dict, batch: dict):
    """One step, ``batch['tokens']`` (B, 1) or ``batch['embeddings']`` (B,
    1, D), at ``state['pos']`` → (fp32 logits (B, padded_vocab) or (B, C,
    padded_vocab), state at pos + 1)."""
    x = _embed_input(params, cfg, batch)
    pos = state["pos"]
    x, layers = stack_decode(params, cfg, state["layers"], x, pos)
    x = norm_fn(cfg)(params["final_norm.scale"], x, cfg.norm_eps)
    return _logits(params, x[:, 0]), {"layers": layers, "pos": pos + 1}
