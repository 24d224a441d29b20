"""Layer stack: per-kind mixers, dense or MoE FFN, the stack with remat,
and its one-token decode.

Port of ``repro.models.blocks`` (``_attn_cfg``, ``_moe_cfg``,
``_rnn_cfg``, ``_mlstm_cfg``, ``_slstm_cfg``, ``_ffn``,
``_layer_forward``, ``_remat_policy`` (as ``save_dots``), ``stack_forward``,
``init_decode_state``, ``_layer_decode``, ``stack_decode``) for every
layer kind: 'attn', 'local_attn' (sliding window), 'rglru' (Griffin's
recurrent block) and xLSTM's 'mlstm' and 'slstm' cells
(``models/recurrent.py``).  The reference stacks the full pattern periods
under one ``lax.scan`` plus unrolled remainder layers; PyTorch has no
scan to keep compile time flat, so the port keeps one parameter set and
one decode state per layer and runs them in order (``convert.py``
unstacks the reference's trees).

Remat, per layer as the reference's per period: ``"nothing"`` (the
reference's default: save nothing inside a layer, recompute it in the
backward) is ``torch.utils.checkpoint``; ``"dots"`` (the reference's
``checkpoint_dots_with_no_batch_dims``) is the same checkpoint under a
selective policy that saves the outputs of the matrix products without a
batch dimension (``aten.mm``, ``aten.addmm``: every ``x @ W``) and
recomputes everything else, the batched products of attention scores
included; ``"full"`` saves everything.

Parameters live in one flat dict keyed ``layers.<i>.<name>``:
``norm1.scale``, ``mixer.<attention, Griffin, mLSTM or sLSTM param>``,
``norm2.scale``, ``ffn.w_in`` (d, 2·d_ff when gated) and ``ffn.w_out``
(d_ff, d) — or, with ``n_experts``, the MoE FFN's ``ffn.router``,
``ffn.experts_in``, ``ffn.experts_out`` and (shared experts)
``ffn.shared_in``, ``ffn.shared_out`` (``models/moe.py``).  An xLSTM cell
keeps its projections inside the mixer: its layer has no ``norm2`` and
no FFN, nor has any layer when ``d_ff == 0``.  The stack returns the
hidden states and the MoE auxiliary loss summed over layers (0 for dense
layers).  Under remat the recompute routes every token as the forward
did: routing is a function of the layer's input alone.  In decode the
MoE FFN routes the (B, 1, D) step as B groups of one token, as the
reference's does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.annotate import constrain, gate_halves, unsharded
from repro_torch.models import recurrent as rec
from repro_torch.models.attention import (AttentionConfig, attention, decode_attention,
                                          init_attention, init_kv_cache)
from repro_torch.models.config import ModelConfig, validate_config
from repro_torch.models.layers import activation_fn, dense_init, layer_norm, rms_norm
from repro_torch.models.moe import MoEConfig, init_moe, moe_ffn

__all__ = ["init_stack", "stack_forward", "init_decode_state", "stack_decode",
           "layer_params", "attn_config", "moe_config", "rnn_config", "mlstm_config",
           "slstm_config", "norm_fn"]

_XLSTM_KINDS = ("mlstm", "slstm")


def attn_config(cfg: ModelConfig, kind: str = "attn") -> AttentionConfig:
    return AttentionConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections,
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


def mlstm_config(cfg: ModelConfig) -> rec.MLSTMConfig:
    return rec.MLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, d_head=cfg.head_dim,
                           chunk=cfg.mlstm_chunk, conv_width=cfg.conv_width)


def slstm_config(cfg: ModelConfig) -> rec.SLSTMConfig:
    return rec.SLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, d_head=cfg.head_dim)


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
    elif kind == "mlstm":
        mixer = rec.init_mlstm(mlstm_config(cfg), generator, device)
    elif kind == "slstm":
        mixer = rec.init_slstm(slstm_config(cfg), generator, device)
    else:
        mixer = init_attention(attn_config(cfg, kind), generator, device)
    p.update({f"mixer.{k}": v for k, v in mixer.items()})
    if cfg.d_ff and kind not in _XLSTM_KINDS:
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
    validate_config(cfg)
    out = {}
    for i, kind in enumerate(cfg.layer_kinds):
        for k, v in _init_layer(cfg, kind, generator, device).items():
            out[f"layers.{i}.{k}"] = v
    return out


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    w_in = p["w_in"].to(x.dtype)
    halves = gate_halves(w_in, x.numel() // x.shape[-1]) if cfg.gated_ffn else None
    if halves is not None:  # on a mesh that splits the hidden dim
        g, u = (constrain(x @ w, "batch", None, "tp") for w in halves)
        return (act(g) * u) @ p["w_out"].to(x.dtype)
    h = constrain(x @ w_in, "batch", None, "tp")
    if cfg.gated_ffn:
        g, u = torch.chunk(h, 2, dim=-1)
        h = act(g) * u
    else:
        h = act(h)
    return h @ p["w_out"].to(x.dtype)


def _ffn_residual(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x + FFN(norm2(x)) and the MoE auxiliary loss (0 for a dense FFN);
    the MoE dispatches each batch row as one group.  A layer without an
    FFN (``d_ff == 0``, an xLSTM cell) returns x."""
    aux = torch.zeros((), device=x.device)
    if "norm2.scale" not in p:
        return x, aux
    h = norm_fn(cfg)(p["norm2.scale"], x, cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_ffn(_sub(p, "ffn."), moe_config(cfg), h)
    else:
        y = _ffn(_sub(p, "ffn."), cfg, h)
    return x + _reduced(y), aux


def _reduced(y: torch.Tensor) -> torch.Tensor:
    """A sub-block's output pinned to whole rows before its residual add: on
    a mesh the tensor-parallel partial sums reduce here (an all-reduce), not
    into a sequence split that later reshapes cannot follow."""
    return constrain(y, "batch", None, None)


def _layer_forward(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, positions):
    """Returns (x', aux): aux is the MoE load-balancing loss, 0 for a dense
    layer."""
    p = unsharded(p)  # on a mesh, ZeRO-3: the layer's weights gathered here
    x = constrain(x, "batch", None, None)
    h = norm_fn(cfg)(p["norm1.scale"], x, cfg.norm_eps)
    mp = _sub(p, "mixer.")
    if kind == "rglru":
        mixed = rec.griffin_block(mp, rnn_config(cfg), h)
    elif kind == "mlstm":
        mixed = rec.mlstm(mp, mlstm_config(cfg), h)
    elif kind == "slstm":
        mixed = rec.slstm(mp, slstm_config(cfg), h)
    else:
        mixed = attention(mp, attn_config(cfg, kind), h, positions)
    return _ffn_residual(p, cfg, x + _reduced(mixed))


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_dots(ctx, op, *args, **kwargs):
    """Remat ``"dots"``'s selective policy: keep the output of a matrix
    product without a batch dimension, recompute every other op."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    # looked up at call time, so a caller may wrap the policy
    return create_selective_checkpoint_contexts(save_dots)


def stack_forward(params: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """Run every layer in order. x (B, T, D) → (x', aux summed over layers);
    under autograd each layer is checkpointed as ``cfg.remat_policy`` says."""
    policy = cfg.remat_policy if torch.is_grad_enabled() else "full"
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(cfg.layer_kinds):
        p = layer_params(params, i)
        if policy == "full":
            x, a = _layer_forward(p, cfg, kind, x, positions)
        else:
            kw = {"context_fn": _dots_context} if policy == "dots" else {}
            x, a = checkpoint(_layer_forward, p, cfg, kind, x, positions,
                              use_reentrant=False, **kw)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# decode: one state per layer, in layer order
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """Per-layer decode states: a bf16 KV cache for an attention layer (a
    ring of ``window`` slots for 'local_attn'), {h, conv} for 'rglru',
    {C, n, m, conv} for 'mlstm', {c, n, h, m} for 'slstm'."""
    validate_config(cfg)
    return [_init_layer_state(cfg, kind, batch, max_len, device) for kind in cfg.layer_kinds]


def _init_layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    if kind == "rglru":
        return rec.init_griffin_state(rnn_config(cfg), batch, device)
    if kind == "mlstm":
        return rec.init_mlstm_state(mlstm_config(cfg), batch, device)
    if kind == "slstm":
        return rec.init_slstm_state(slstm_config(cfg), batch, device)
    return init_kv_cache(attn_config(cfg, kind), batch, max_len, device)


def _layer_decode(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, state: dict,
                  pos: int):
    p = unsharded(p)
    h = norm_fn(cfg)(p["norm1.scale"], x, cfg.norm_eps)
    mp = _sub(p, "mixer.")
    if kind == "rglru":
        mixed, state = rec.griffin_decode(mp, rnn_config(cfg), h, state)
    elif kind == "mlstm":
        mixed, state = rec.mlstm_decode(mp, mlstm_config(cfg), h, state)
    elif kind == "slstm":
        mixed, state = rec.slstm_decode(mp, slstm_config(cfg), h, state)
    else:
        mixed, state = decode_attention(mp, attn_config(cfg, kind), h, state, pos)
    x, _ = _ffn_residual(p, cfg, x + _reduced(mixed))
    return x, state


def stack_decode(params: dict, cfg: ModelConfig, state: list, x: torch.Tensor, pos: int):
    """One-token decode through the stack.  x (B, 1, D) at position ``pos``
    (a host integer) → (x', new per-layer states)."""
    new = []
    for i, kind in enumerate(cfg.layer_kinds):
        x, s = _layer_decode(layer_params(params, i), cfg, kind, x, state[i], pos)
        new.append(s)
    return x, new
