"""Layer stack: dense or MoE FFN, one pre-norm layer, the stack with remat.

Port of the ``'attn'`` path of ``repro.models.blocks`` (``_moe_cfg``,
``_ffn``, ``_layer_forward``, ``stack_forward``).  The reference stacks the full
pattern periods under one ``lax.scan`` plus unrolled remainder layers;
PyTorch has no scan to keep compile time flat, so the port keeps one
parameter set per layer and runs them in order (``convert.py`` unstacks
the reference's tree).  Remat policy ``"nothing"`` (the reference's
default: save nothing inside a layer, recompute it in the backward) is
``torch.utils.checkpoint`` around each layer; ``"full"`` saves
everything; ``"dots"`` is not ported.

Parameters live in one flat dict keyed ``layers.<i>.<name>``:
``norm1.scale``, ``mixer.<attention param>``, ``norm2.scale``,
``ffn.w_in`` (d, 2·d_ff when gated) and ``ffn.w_out`` (d_ff, d) — or, with
``n_experts``, the MoE FFN's ``ffn.router``, ``ffn.experts_in``,
``ffn.experts_out`` and (shared experts) ``ffn.shared_in``,
``ffn.shared_out`` (``models/moe.py``).  The stack returns the hidden
states and the MoE auxiliary loss summed over layers (0 for dense layers).
Under remat the recompute routes every token as the forward did: routing
is a function of the layer's input alone.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import AttentionConfig, attention, init_attention
from repro_torch.models.config import ModelConfig, require_ported
from repro_torch.models.layers import activation_fn, dense_init, layer_norm, rms_norm
from repro_torch.models.moe import MoEConfig, init_moe, moe_ffn

__all__ = ["init_stack", "stack_forward", "layer_params", "attn_config", "moe_config",
           "norm_fn"]


def attn_config(cfg: ModelConfig) -> AttentionConfig:
    return AttentionConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
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


def norm_fn(cfg: ModelConfig):
    return rms_norm if cfg.norm == "rmsnorm" else layer_norm


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters with the ``layers.<i>.`` prefix removed."""
    prefix = f"layers.{i}."
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _init_layer(cfg: ModelConfig, generator, device) -> dict:
    d = cfg.d_model
    p = {"norm1.scale": torch.ones((d,), device=device)}
    for k, v in init_attention(attn_config(cfg), generator, device).items():
        p[f"mixer.{k}"] = v
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
    for i in range(cfg.n_layers):
        for k, v in _init_layer(cfg, generator, device).items():
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


def _layer_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """Returns (x', aux): aux is the MoE load-balancing loss, 0 for a dense
    layer; the MoE dispatches each batch row as one group."""
    norm = norm_fn(cfg)
    aux = torch.zeros((), device=x.device)
    h = norm(p["norm1.scale"], x, cfg.norm_eps)
    x = x + attention(_sub(p, "mixer."), attn_config(cfg), h, positions)
    if cfg.d_ff:
        h = norm(p["norm2.scale"], x, cfg.norm_eps)
        if cfg.n_experts:
            y, aux = moe_ffn(_sub(p, "ffn."), moe_config(cfg), h)
            x = x + y
        else:
            x = x + _ffn(_sub(p, "ffn."), cfg, h)
    return x, aux


def stack_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """Run every layer in order. x (B, T, D) → (x', aux summed over layers)."""
    if cfg.remat_policy not in ("nothing", "full"):
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported to repro_torch "
            "(ROADMAP.md queue 1, slice 5); use 'nothing' or 'full'"
        )
    remat = cfg.remat_policy == "nothing" and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        if remat:
            x, a = checkpoint(_layer_forward, p, cfg, x, positions, use_reentrant=False)
        else:
            x, a = _layer_forward(p, cfg, x, positions)
        aux = aux + a
    return x, aux
