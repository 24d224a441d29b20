"""Mixture-of-Experts FFN with top-k routing and gather-based dispatch.

Port of ``repro.models.moe`` (``MoEConfig``, ``init_moe``, ``moe_ffn``).
Functions on tensors, like the rest of ``models/``.  Each step is the
reference's:

  1. route: router logits in the compute dtype, then fp32; the top-k
     experts per token with ties to the lower expert (``lax.top_k``'s
     order: a stable descending sort, first K), gates renormalised by a
     softmax over the K;
  2. bucket: each (token, choice) pair's position in its expert from a
     cumsum over the token-major (S·K) flattening; pairs at or past the
     capacity C are dropped, in that order;
  3. scatter token ids + 1 into an (E, C) buffer per group;
  4. gather tokens → (G, E, C, D), empty slots zero;
  5. the per-expert FFN as a batched product on (G, E, C, D);
  6. gather each pair's output back, gate-weight it in the compute dtype
     and sum the K contiguous copies per token.

Shared experts run as one fused FFN of width ``d_ff_expert ·
n_shared_experts``.  The Switch load-balancing loss E·Σ_e mean(p_e)·
mean(top-1 = e) is returned beside the output; its gradient flows through
the router probabilities only.  Parameters: ``router`` (d, E),
``experts_in`` (E, d, 2f gated / f), ``experts_out`` (E, f, d), and with
shared experts ``shared_in`` (d, 2·f·n_shared) and ``shared_out``
(f·n_shared, d).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.annotate import constrain, gate_halves
from repro_torch.models.layers import activation_fn, dense_init

__all__ = ["MoEConfig", "moe_shapes", "init_moe", "moe_capacity", "moe_route", "moe_slots",
           "moe_ffn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    n_shared_experts: int = 0  # DeepSeek/Moonlight-style always-on experts
    capacity_factor: float = 1.25
    activation: str = "silu"
    gated: bool = True  # SwiGLU-style experts


def moe_shapes(cfg: MoEConfig) -> dict[str, tuple[int, ...]]:
    """Each parameter's name and shape."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    mult = 2 if cfg.gated else 1
    shapes = {"router": (d, E), "experts_in": (E, d, mult * f), "experts_out": (E, f, d)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes.update(shared_in=(d, mult * fs), shared_out=(fs, d))
    return shapes


def init_moe(cfg: MoEConfig, generator: torch.Generator, device) -> dict:
    """fp32 weights, truncated normal scaled by 1/√fan_in (each expert's
    fan_in: d for ``experts_in``, f for ``experts_out``)."""
    return {name: dense_init(shape, generator, device, fan=shape[-2])
            for name, shape in moe_shapes(cfg).items()}


def moe_capacity(cfg: MoEConfig, S: int) -> int:
    """Slots per expert and group: int(S·K/E·capacity_factor + 0.5), then
    at least 8 and a multiple of 8 (the reference's float order)."""
    C = int(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor + 0.5)
    return max(8, ((C + 7) // 8) * 8)


def _ffn(cfg: MoEConfig, h: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    if cfg.gated:
        g, u = torch.chunk(h, 2, dim=-1)  # gate first, as jnp.split
        return act(g) * u
    return act(h)


def moe_route(params: dict, cfg: MoEConfig, x: torch.Tensor):
    """Routing of x (G, S, D): (fp32 router logits (G, S, E), expert ids
    (G, S, K) int64, renormalised gates (G, S, K) fp32)."""
    # on a mesh the router's logits whole rows (the gradient too, or the
    # router's weight gradient would flatten a split sequence)
    logits32 = constrain((x @ params["router"].to(x.dtype)).float(), "batch", None, None)
    order = torch.sort(logits32, dim=-1, descending=True, stable=True).indices
    eidx = order[..., :cfg.top_k]
    gates = torch.softmax(torch.gather(logits32, -1, eidx), dim=-1)
    return logits32, eidx, gates


def moe_slots(eidx: torch.Tensor, n_experts: int, C: int):
    """Bucketing of expert ids (G, S, K): each (token, choice) pair's slot
    in the (E·C) buffer of its group, (G, S·K) int64, and whether it is
    kept.  A pair's position in its expert counts the pairs before it in
    the token-major (S·K) order; pairs at or past C are dropped."""
    G, S, K = eidx.shape
    flat_e = eidx.reshape(G, S * K)
    onehot = F.one_hot(flat_e, n_experts)
    pos = torch.sum((torch.cumsum(onehot, dim=1) - 1) * onehot, dim=-1)
    keep = pos < C
    return flat_e * C + torch.where(keep, pos, 0), keep


def _dispatch(x: torch.Tensor, eidx: torch.Tensor, E: int, C: int):
    """Each pair's slot and whether it is kept (:func:`moe_slots`), and the
    tokens gathered into their slots, (G, E, C, D), empty slots zero."""
    G, S, D = x.shape
    K = eidx.shape[-1]
    slot, keep = moe_slots(eidx, E, C)
    tok = torch.arange(S, device=x.device).repeat_interleave(K) + 1
    buf = torch.zeros((G, E * C), dtype=torch.int64, device=x.device)
    buf.scatter_add_(1, slot, torch.where(keep, tok, 0))
    src = (buf - 1).clamp(min=0)
    gathered = torch.gather(x, 1, src[..., None].expand(G, E * C, D))
    return slot, keep, torch.where((buf > 0)[..., None], gathered, 0).reshape(G, E, C, D)


def _combine(ex_out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """Each pair's expert output back in token order, gate-weighted in the
    compute dtype, the K copies of a token summed → (G, S, D)."""
    G, E, C, D = ex_out.shape
    S, K = gates.shape[1:]
    dtype = ex_out.dtype
    vals = torch.gather(ex_out.reshape(G, E * C, D), 1, slot[..., None].expand(G, S * K, D))
    vals = torch.where(keep[..., None], vals, 0).to(dtype)
    w = gates.reshape(G, S * K, 1).to(dtype)
    return torch.sum((vals * w).reshape(G, S, K, D), dim=2)


def _experts(cfg: MoEConfig, gathered: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """The per-expert FFN as batched products on (G, E, C, D).  On a mesh it
    runs on each device's own slots (``local_map``) with its experts'
    weights made whole: DTensor's einsum views a permuted operand that
    its shard cannot view.  Each weight's expert dim keeps the slots'
    expert placements and every other dim is gathered (ZeRO-3); a
    weight's gradient is a partial sum over the devices that split the
    groups."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def local(g, wi, wo):
        h = torch.einsum("gecd,edf->gecf", g, wi)
        return torch.einsum("gecf,efd->gecd", _ffn(cfg, h), wo)

    if not isinstance(gathered, DTensor):
        return local(gathered, w_in, w_out)
    from torch.distributed.tensor.experimental import local_map

    slots = list(gathered.placements)
    weights = [Shard(0) if p == Shard(1) else Replicate() for p in slots]
    grads = [Partial() if p == Shard(0) else w for p, w in zip(slots, weights)]
    return local_map(local, out_placements=slots, in_placements=(slots, weights, weights),
                     in_grad_placements=(slots, grads, grads),
                     device_mesh=gathered.device_mesh, redistribute_inputs=True)(
        gathered, w_in, w_out)


def _group_local(fn, n_out: int, x: torch.Tensor, *others: torch.Tensor):
    """``fn(x, *others)``; on a mesh (a DTensor ``x``) run by ``local_map`` on
    each device's own groups: the indices are group-local, and scatter and
    gather along a split dim have no sharding strategy.  Every operand and
    output keeps its split of the groups (dim 0) and is whole otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return fn(x, *others)
    from torch.distributed.tensor.experimental import local_map

    rows = [p if p == Shard(0) else Replicate() for p in x.placements]
    return local_map(fn, out_placements=(rows,) * n_out if n_out > 1 else rows,
                     in_placements=(rows,) * (1 + len(others)), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, *others)


def moe_ffn(params: dict, cfg: MoEConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x (G, S, D) token groups → (y (G, S, D), aux ()).

    Groups dispatch independently, each with capacity C per expert
    (:func:`moe_capacity`)."""
    S = x.shape[1]
    E = cfg.n_experts
    C = moe_capacity(cfg, S)
    dtype = x.dtype

    logits32, eidx, gates = moe_route(params, cfg, x)
    probs = torch.softmax(logits32, dim=-1)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(eidx[..., 0], E).float(), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    slot, keep, gathered = _group_local(lambda a, b: _dispatch(a, b, E, C), 3, x, eidx)
    # expert parallelism: groups over batch, experts over model (the
    # group-local → expert-sharded reshard is the all-to-all)
    gathered = constrain(gathered, "batch", "tp", None, None)
    ex_out = _experts(cfg, gathered, params["experts_in"].to(dtype),
                      params["experts_out"].to(dtype))
    ex_out = constrain(ex_out, "batch", "tp", None, None)
    y = _group_local(_combine, 1, ex_out, slot, keep, gates)

    if cfg.n_shared_experts:
        w_in = params["shared_in"].to(dtype)
        halves = gate_halves(w_in, x.numel() // x.shape[-1]) if cfg.gated else None
        if halves is not None:  # on a mesh that splits the hidden dim
            g, u = (x @ w for w in halves)
            h = activation_fn(cfg.activation)(g) * u
        else:
            h = _ffn(cfg, x @ w_in)
        y = y + h @ params["shared_out"].to(dtype)
    return y, aux
