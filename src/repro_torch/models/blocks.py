"""Layer stack: per-kind mixers, dense or MoE FFN, the stack with remat,
and its one-token decode.

Port of ``repro.models.blocks`` (``_attn_cfg``, ``_moe_cfg``,
``_rnn_cfg``, ``_ffn``, ``_layer_forward``, ``stack_forward``,
``init_decode_state``, ``_layer_decode``, ``stack_decode``) for the
layer kinds 'attn', 'local_attn' (sliding window) and 'rglru' (Griffin's
recurrent block, ``models/recurrent.py``).  The reference stacks the full
pattern periods under one ``lax.scan`` plus unrolled remainder layers;
PyTorch has no scan to keep compile time flat, so the port keeps one
parameter set and one decode state per layer and runs them in order
(``convert.py`` unstacks the reference's trees).  Remat policy
``"nothing"`` (the reference's default: save nothing inside a layer,
recompute it in the backward) is ``torch.utils.checkpoint`` around each
layer; ``"full"`` saves everything; ``"dots"`` is not ported
(``require_ported`` raises).

Parameters live in one flat dict keyed ``layers.<i>.<name>``:
``norm1.scale``, ``mixer.<attention or Griffin param>``, ``norm2.scale``,
``ffn.w_in`` (d, 2·d_ff when gated) and ``ffn.w_out`` (d_ff, d) — or, with
``n_experts``, the MoE FFN's ``ffn.router``, ``ffn.experts_in``,
``ffn.experts_out`` and (shared experts) ``ffn.shared_in``,
``ffn.shared_out`` (``models/moe.py``).  The stack returns the hidden
states and the MoE auxiliary loss summed over layers (0 for dense layers).
Under remat the recompute routes every token as the forward did: routing
is a function of the layer's input alone.  In decode the MoE FFN routes
the (B, 1, D) step as B groups of one token, as the reference's does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import recurrent as rec
from repro_torch.models.attention import (AttentionConfig, attention, decode_attention,
                                          init_attention, init_kv_cache)
from repro_torch.models.config import ModelConfig, require_ported
from repro_torch.models.layers import activation_fn, dense_init, layer_norm, rms_norm
from repro_torch.models.moe import MoEConfig, init_moe, moe_ffn

__all__ = ["init_stack", "stack_forward", "init_decode_state", "stack_decode",
           "layer_params", "attn_config", "moe_config", "rnn_config", "norm_fn"]


def attn_config(cfg: ModelConfig, kind: str = "attn") -> AttentionConfig:
    return AttentionConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
        window=cfg.window if kind == "local_attn" else None,
        blockwise_threshold=cfg.blockwise_threshold,
        chunk_q=cfg.attn_chunk_q,
        chunk_kv=cfg.attn_chunk_kv,
    )


def moe_config(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model,
        d_ff_expert=cfg.d_ff,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        n_shared_experts=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor,
        activation=cfg.activation,
        gated=cfg.gated_ffn,
    )


def rnn_config(cfg: ModelConfig) -> rec.RGLRUConfig:
    return rec.RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.d_rnn or cfg.d_model,
                           conv_width=cfg.conv_width)


def norm_fn(cfg: ModelConfig):
    return rms_norm if cfg.norm == "rmsnorm" else layer_norm


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters with the ``layers.<i>.`` prefix removed."""
    prefix = f"layers.{i}."
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _init_layer(cfg: ModelConfig, kind: str, generator, device) -> dict:
    d = cfg.d_model
    p = {"norm1.scale": torch.ones((d,), device=device)}
    if kind == "rglru":
        mixer = rec.init_griffin_block(rnn_config(cfg), generator, device)
    else:
        mixer = init_attention(attn_config(cfg, kind), generator, device)
    p.update({f"mixer.{k}": v for k, v in mixer.items()})
    if cfg.d_ff:
        p["norm2.scale"] = torch.ones((d,), device=device)
        if cfg.n_experts:
            ffn = init_moe(moe_config(cfg), generator, device)
        else:
            mult = 2 if cfg.gated_ffn else 1
            ffn = {"w_in": dense_init((d, mult * cfg.d_ff), generator, device),
                   "w_out": dense_init((cfg.d_ff, d), generator, device)}
        p.update({f"ffn.{k}": v for k, v in ffn.items()})
    return p


def init_stack(cfg: ModelConfig, generator, device) -> dict:
    """Flat ``layers.<i>.*`` fp32 parameters for every layer."""
    require_ported(cfg)
    out = {}
    for i, kind in enumerate(cfg.layer_kinds):
        for k, v in _init_layer(cfg, kind, generator, device).items():
            out[f"layers.{i}.{k}"] = v
    return out


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = x @ p["w_in"].to(x.dtype)
    if cfg.gated_ffn:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act(g) * u
    else:
        h = act(h)
    return h @ p["w_out"].to(x.dtype)


def _ffn_residual(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x + FFN(norm2(x)) and the MoE auxiliary loss (0 for a dense FFN);
    the MoE dispatches each batch row as one group."""
    aux = torch.zeros((), device=x.device)
    if not cfg.d_ff:
        return x, aux
    h = norm_fn(cfg)(p["norm2.scale"], x, cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_ffn(_sub(p, "ffn."), moe_config(cfg), h)
        return x + y, aux
    return x + _ffn(_sub(p, "ffn."), cfg, h), aux


def _layer_forward(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, positions):
    """Returns (x', aux): aux is the MoE load-balancing loss, 0 for a dense
    layer."""
    h = norm_fn(cfg)(p["norm1.scale"], x, cfg.norm_eps)
    if kind == "rglru":
        mixed = rec.griffin_block(_sub(p, "mixer."), rnn_config(cfg), h)
    else:
        mixed = attention(_sub(p, "mixer."), attn_config(cfg, kind), h, positions)
    return _ffn_residual(p, cfg, x + mixed)


def stack_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """Run every layer in order. x (B, T, D) → (x', aux summed over layers)."""
    remat = cfg.remat_policy == "nothing" and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(cfg.layer_kinds):
        p = layer_params(params, i)
        if remat:
            x, a = checkpoint(_layer_forward, p, cfg, kind, x, positions,
                              use_reentrant=False)
        else:
            x, a = _layer_forward(p, cfg, kind, x, positions)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# decode: one state per layer, in layer order
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """Per-layer decode states: a bf16 KV cache for an attention layer (a
    ring of ``window`` slots for 'local_attn'), {h, conv} for 'rglru'."""
    require_ported(cfg)
    return [rec.init_griffin_state(rnn_config(cfg), batch, device) if kind == "rglru"
            else init_kv_cache(attn_config(cfg, kind), batch, max_len, device)
            for kind in cfg.layer_kinds]


def _layer_decode(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, state: dict,
                  pos: int):
    h = norm_fn(cfg)(p["norm1.scale"], x, cfg.norm_eps)
    if kind == "rglru":
        mixed, state = rec.griffin_decode(_sub(p, "mixer."), rnn_config(cfg), h, state)
    else:
        mixed, state = decode_attention(_sub(p, "mixer."), attn_config(cfg, kind), h,
                                        state, pos)
    x, _ = _ffn_residual(p, cfg, x + mixed)
    return x, state


def stack_decode(params: dict, cfg: ModelConfig, state: list, x: torch.Tensor, pos: int):
    """One-token decode through the stack.  x (B, 1, D) at position ``pos``
    (a host integer) → (x', new per-layer states)."""
    new = []
    for i, kind in enumerate(cfg.layer_kinds):
        x, s = _layer_decode(layer_params(params, i), cfg, kind, x, state[i], pos)
        new.append(s)
    return x, new
