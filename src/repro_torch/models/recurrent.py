"""Recurrent sequence mixers: Griffin's RG-LRU block, and xLSTM's mLSTM
and sLSTM cells.

Port of ``repro.models.recurrent`` (``RGLRUConfig``,
``init_griffin_block``, ``_rglru_scan``, ``_causal_conv``,
``griffin_block``, ``init_griffin_state``, ``griffin_decode``;
``MLSTMConfig``, ``init_mlstm``, ``_mlstm_chunk_parallel``, ``mlstm``,
``init_mlstm_state``, ``mlstm_decode``; ``SLSTMConfig``, ``init_slstm``,
``_slstm_step``, ``slstm``, ``init_slstm_state``, ``slstm_decode``).
Each mixer has a parallel form for training and prefill and an O(1)
per-token decode form with an explicit state, over the same weights.

The reference's ``lax.associative_scan`` is plain JAX, not a Pallas
kernel, so the scan is plain torch: a Hillis–Steele doubling scan over
the pairs (a, b) of h_t = a_t·h_{t−1} + b_t in fp32, ⌈log₂T⌉ passes of
``b[t] += a[t]·b[t−o]; a[t] *= a[t−o]``.  It reassociates the
recurrence like the reference's scan (not in the same tree), and it
never forms exp(−Σ log a), which overflows over long T.

Parameters: ``w_x``, ``w_gate`` (d, r), ``w_out`` (r, d), ``conv``
(K, r), ``w_a``, ``w_i`` (r, r), ``lam``, ``b_a``, ``b_i`` (r,).  State:
``h`` (B, r) fp32 and ``conv`` (B, K − 1, r), the last K − 1 inputs of
the convolution.

The mLSTM runs the reference's stabilised chunkwise form in fp32: within
a chunk a masked quadratic product with gate-derived decay weights,
across chunks the (C, n, m) state carried by a Python loop (the
reference's ``lax.scan``).  The sLSTM mixes its heads' memories through
``r_in``, so it is sequential: a Python loop of ``_slstm_step`` over T
in fp32.  Both are plain ``jnp`` in the reference (no Pallas kernel), so
they are plain torch here.  mLSTM parameters: ``w_up`` (d, 2·di) (inner,
gate), ``w_down`` (di, d), ``conv`` (K, di), ``wq``/``wk``/``wv`` (di, H,
d_head), ``w_if`` (di, 2H), ``b_if`` (2H,), ``skip_scale`` and
``out_norm.scale`` (di,); state {C (B, H, d, d), n (B, H, d), m (B, H),
conv (B, K − 1, di)}, all fp32.  sLSTM parameters: ``w_in`` (d, 4·di)
(gates i, f, z, o), ``r_in`` (4, H, d_head, d_head), ``b`` (4·di,),
``w_down`` (di, d), ``out_norm.scale`` (di,); state {c, n, h (B, H, d),
m (B, H)}, fp32, the reference's tuple (c, n, h, m) by name.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.annotate import (constrain, local_pointwise, per_shard, pin_grad,
                                              whole_heads)
from repro_torch.models import loops
from repro_torch.models.layers import activation_fn, dense_init, rms_norm

__all__ = ["RGLRUConfig", "init_griffin_block", "griffin_block", "init_griffin_state",
           "griffin_decode", "MLSTMConfig", "init_mlstm", "mlstm", "init_mlstm_state",
           "mlstm_decode", "SLSTMConfig", "init_slstm", "slstm", "init_slstm_state",
           "slstm_decode"]

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness constant
_gelu = activation_fn("gelu")  # jax.nn.gelu's default (tanh) form
_silu = activation_fn("silu")  # jax.nn.silu's rounding


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int  # recurrence width
    conv_width: int = 4


def init_griffin_block(cfg: RGLRUConfig, generator, device) -> dict:
    """fp32 weights; Λ drawn as the reference's: σ(Λ)^c uniform in
    [0.9², 0.999²] (Griffin §2.4)."""
    d, r = cfg.d_model, cfg.d_rnn
    u = torch.empty((r,), device=device).uniform_(0.9**2, 0.999**2, generator=generator)
    root = u ** (1.0 / _C_RGLRU)
    return {
        "w_x": dense_init((d, r), generator, device),  # input branch
        "w_gate": dense_init((d, r), generator, device),  # gelu gate branch
        "w_out": dense_init((r, d), generator, device),
        "conv": dense_init((cfg.conv_width, r), generator, device) * 0.1,
        "w_a": dense_init((r, r), generator, device),  # recurrence gate
        "w_i": dense_init((r, r), generator, device),  # input gate
        "lam": torch.log(root / (1 - root)),
        "b_a": torch.zeros((r,), device=device),
        "b_i": torch.zeros((r,), device=device),
    }


def _gates(p: dict, u32: torch.Tensor):
    """a_t = exp(c·r_t·log σ(Λ)) and the input term √(1 − a_t²)·i_t·u_t."""
    # on a mesh the products' partial sums reduced before the biases join
    # (some PyTorch releases cannot turn a split bias into a partial one)
    rows = ("batch",) + (None,) * (u32.dim() - 2) + ("tp",)
    r_g = torch.sigmoid(constrain(u32 @ p["w_a"], *rows) + p["b_a"])
    i_g = torch.sigmoid(constrain(u32 @ p["w_i"], *rows) + p["b_i"])
    a = torch.exp(_C_RGLRU * r_g * _log_sigmoid(p["lam"]))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_g * u32)
    return a, b


def _rglru_scan(p: dict, u: torch.Tensor) -> torch.Tensor:
    """RG-LRU over u (B, T, R): h_t = a_t·h_{t−1} + b_t from h_0 = 0, in
    fp32, cast back to ``u.dtype``."""
    a, b = _gates(p, u.float())
    o = 1
    while o < u.shape[1]:
        b = torch.cat([b[:, :o], b[:, o:] + a[:, o:] * b[:, :-o]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return b.to(u.dtype)


def _causal_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal temporal conv of width K over x (B, T, R):
    y_t = Σ_k w_k·x_{t−K+1+k}, K unrolled adds in the reference's order."""
    if isinstance(x, DTensor):
        return _causal_conv_per_shard(w, x)
    K, T = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pads[:, k:k + T] * w[k]
    return out


def _causal_conv_per_shard(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The causal conv on a mesh, each device on its own rows and channels
    (``local_map``; some PyTorch releases cannot place its padding): x
    whole along T, the weight's channels split as x's, its gradient a
    partial sum over the devices that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    x = constrain(x, "batch", None, "tp")
    rows = list(x.placements)
    cols = [Shard(1) if p == Shard(2) else Replicate() for p in rows]
    grads = [Partial() if p == Shard(0) else q for p, q in zip(rows, cols)]
    return local_map(_causal_conv, out_placements=rows, in_placements=(cols, rows),
                     in_grad_placements=(grads, rows), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(w, x)


def griffin_block(p: dict, cfg: RGLRUConfig, x: torch.Tensor) -> torch.Tensor:
    """Griffin recurrent block over x (B, T, D): gate ⊙ RG-LRU(conv(proj(x)))
    → out projection, in ``x.dtype`` (the scan in fp32)."""
    dtype = x.dtype
    gate = _gelu(x @ p["w_gate"].to(dtype))
    u = _causal_conv(p["conv"].to(dtype), x @ p["w_x"].to(dtype))
    # on a mesh whole sequences into and out of the scan (its shifted
    # slices may take a sequence split the out projection cannot flatten)
    h = constrain(_rglru_scan(p, constrain(u, "batch", None, "tp")), "batch", None, "tp")
    return (gate * h) @ p["w_out"].to(dtype)


def init_griffin_state(cfg: RGLRUConfig, batch: int, device,
                       dtype: torch.dtype = torch.float32) -> dict:
    return {"h": torch.zeros((batch, cfg.d_rnn), device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn), dtype=dtype,
                                device=device)}


def griffin_decode(p: dict, cfg: RGLRUConfig, x: torch.Tensor, state: dict):
    """One-token decode.  x (B, 1, D) → (out (B, 1, D), new state).  The
    convolution runs over [state.conv | u] in the state's dtype (fp32),
    as the reference's promotion does."""
    dtype = x.dtype
    xt = x[:, 0]
    gate = _gelu(xt @ p["w_gate"].to(dtype))
    u = xt @ p["w_x"].to(dtype)  # (B, R)
    hist = torch.cat([state["conv"], u[:, None].to(state["conv"].dtype)], dim=1)  # (B, K, R)
    w = p["conv"].to(dtype).to(hist.dtype)
    u32 = torch.einsum("bkr,kr->br", hist, w).float()
    a, b = _gates(p, u32)
    h = a * state["h"] + b
    out = (gate * h.to(dtype)) @ p["w_out"].to(dtype)
    return out[:, None], {"h": h, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory cell), chunkwise parallel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    d_head: int  # = d_inner / n_heads
    expand: float = 2.0
    chunk: int = 256
    conv_width: int = 4


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    # on a mesh shard by shard: log_sigmoid's backward has no sharding strategy
    return local_pointwise(F.logsigmoid, x)


def _fp32_rsqrt(d: int) -> float:
    """1/√d computed in fp32, as the reference's scalar."""
    return float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))


def init_mlstm(cfg: MLSTMConfig, generator, device) -> dict:
    """fp32 weights with the reference's shapes and scales: ``conv`` ×0.1,
    the forget-gate bias 3 (open at init)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.d_head
    di = H * hd
    return {
        "w_up": dense_init((d, 2 * di), generator, device),  # (inner, gate)
        "w_down": dense_init((di, d), generator, device),
        "conv": dense_init((cfg.conv_width, di), generator, device) * 0.1,
        "wq": dense_init((di, di), generator, device).reshape(di, H, hd),
        "wk": dense_init((di, di), generator, device).reshape(di, H, hd),
        "wv": dense_init((di, di), generator, device).reshape(di, H, hd),
        "w_if": dense_init((di, 2 * H), generator, device),  # input/forget gates
        "b_if": torch.cat([torch.zeros((H,), device=device),
                           3.0 * torch.ones((H,), device=device)]),
        "skip_scale": torch.ones((di,), device=device),
        "out_norm.scale": torch.ones((di,), device=device),
    }


def _mlstm_chunk_parallel(q, k, v, log_i, log_f, chunk: int = 256) -> torch.Tensor:
    """Stabilised chunkwise mLSTM in fp32.  q, k, v (B, H, T, d); log_i,
    log_f (B, H, T) → h (B, H, T, d).  Chunks of ``chunk`` steps when it
    divides T, else one chunk of T."""
    B, H, T, d = q.shape
    C = chunk if (chunk and T % chunk == 0) else T
    scale = _fp32_rsqrt(d)
    dev = q.device
    mask = torch.ones((C, C), dtype=torch.bool, device=dev).tril()
    c_st = torch.zeros((B, H, d, d), device=dev)
    n_st = torch.zeros((B, H, d), device=dev)
    m_st = torch.full((B, H), -1e30, device=dev)
    hs = []
    for ci in loops.steps(T // C):
        lo = ci * C
        qc, kc, vc = q[:, :, lo:lo + C], k[:, :, lo:lo + C], v[:, :, lo:lo + C]
        lic, lfc = log_i[..., lo:lo + C], log_f[..., lo:lo + C]
        csum_f = torch.cumsum(lfc, dim=-1)  # Σ_{s≤t} log f_s
        total_f = csum_f[..., -1]
        # intra-chunk decay D[t, s] = exp(csum_f[t] − csum_f[s] + log i_s), s ≤ t
        log_d = csum_f[..., :, None] - csum_f[..., None, :] + lic[..., None, :]
        log_d = torch.where(mask, log_d, -math.inf)
        log_carry = csum_f + m_st[..., None]  # the carried state's decay
        m_t = torch.maximum(log_d.amax(dim=-1), log_carry)
        m_t = torch.clamp(m_t, min=-1e30)
        dw = torch.exp(log_d - m_t[..., None])
        k_s = kc * scale
        s_qk = qc @ k_s.transpose(-1, -2)  # (B, H, C, C)
        sd = s_qk * dw
        intra = sd @ vc
        q_dec = qc * torch.exp(log_carry - m_t)[..., None]
        inter = q_dec @ c_st
        denom_raw = (q_dec @ n_st[..., None])[..., 0] + sd.sum(dim=-1)
        denom = torch.maximum(denom_raw.abs(), torch.exp(-m_t))
        hs.append((intra + inter) / denom[..., None])
        # C' = f_total·C + Σ_s exp(Σ_{u>s} log f_u + log i_s)·k_s v_sᵀ
        m_next = torch.maximum(total_f + m_st,
                               (lic + total_f[..., None] - csum_f).amax(dim=-1))
        w_state = torch.exp(lic + total_f[..., None] - csum_f - m_next[..., None])
        decay = torch.exp(total_f + m_st - m_next)
        wk = k_s * w_state[..., None]
        c_st = decay[..., None, None] * c_st + wk.transpose(-1, -2) @ vc
        n_st = decay[..., None] * n_st + wk.sum(dim=-2)
        m_st = m_next
    return loops.widen(torch.cat(hs, dim=2), 2, T)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('...d,dhk->...hk') as one matrix product in ``x.dtype``."""
    di, h, k = w.shape
    return whole_heads(x @ w.to(x.dtype).reshape(di, h * k), h).unflatten(-1, (h, k))


def _mlstm_out(p: dict, h: torch.Tensor, inner_act: torch.Tensor, gate: torch.Tensor):
    """Output norm, the learned skip, the SiLU gate and the down-projection."""
    dtype = h.dtype
    h = rms_norm(p["out_norm.scale"], h)
    h = h + p["skip_scale"].to(dtype) * inner_act
    h = h * _silu(gate)
    return h @ p["w_down"].to(dtype)


def mlstm(p: dict, cfg: MLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """mLSTM block over x (B, T, D) → (B, T, D), in ``x.dtype`` with the
    gates and the cell in fp32."""
    dtype = x.dtype
    B, T, _ = x.shape
    inner, gate = torch.chunk(x @ p["w_up"].to(dtype), 2, dim=-1)
    inner = _causal_conv(p["conv"].to(dtype), inner)
    inner_act = _silu(inner)
    q = _heads(inner_act, p["wq"]).transpose(1, 2)  # (B, H, T, d)
    k = _heads(inner_act, p["wk"]).transpose(1, 2)
    v = _heads(inner, p["wv"]).transpose(1, 2)
    gf = inner.float() @ p["w_if"] + p["b_if"]
    log_i, log_f = torch.chunk(gf, 2, dim=-1)  # (B, T, H) each
    # on a mesh, whole sequences into and out of the chunks (B, H, T, d): a
    # split the chunks' products may pick, or their gradients bring back,
    # would reach the projections' reshapes
    # — and each device runs the chunks on its own rows and heads: batched
    # products over a batch and a head split merge them into one dim,
    # which some PyTorch releases refuse and others split strided
    q, k, v = (constrain(t.float(), "batch", "tp", None, None) for t in (q, k, v))
    h = per_shard(lambda q, k, v, li, lf: _mlstm_chunk_parallel(q, k, v, li, lf,
                                                                chunk=cfg.chunk),
                  q, k, v, log_i.transpose(1, 2), _log_sigmoid(log_f).transpose(1, 2))
    h = constrain(h, "batch", "tp", None, None)
    h = whole_heads(h.transpose(1, 2).reshape(B, T, -1), cfg.n_heads).to(dtype)
    return _mlstm_out(p, h, inner_act, gate)


def init_mlstm_state(cfg: MLSTMConfig, batch: int, device) -> dict:
    H, d = cfg.n_heads, cfg.d_head
    return {"C": torch.zeros((batch, H, d, d), device=device),
            "n": torch.zeros((batch, H, d), device=device),
            "m": torch.full((batch, H), -1e30, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, H * d), device=device)}


def mlstm_decode(p: dict, cfg: MLSTMConfig, x: torch.Tensor, state: dict):
    """One-token mLSTM step.  x (B, 1, D) → (out (B, 1, D), new state).  The
    conv history is kept in fp32 and cast to ``x.dtype`` for the product,
    as the reference's."""
    dtype = x.dtype
    B = x.shape[0]
    inner, gate = torch.chunk(x[:, 0] @ p["w_up"].to(dtype), 2, dim=-1)
    hist = torch.cat([state["conv"].to(dtype), inner[:, None]], dim=1)  # (B, K, di)
    inner_c = torch.einsum("bkr,kr->br", hist, p["conv"].to(dtype))
    inner_act = _silu(inner_c)
    q = _heads(inner_act, p["wq"]).float()  # (B, H, d)
    k = _heads(inner_act, p["wk"]).float()
    v = _heads(inner_c, p["wv"]).float()
    gf = inner_c.float() @ p["w_if"] + p["b_if"]
    log_i, log_f = torch.chunk(gf, 2, dim=-1)  # (B, H)
    log_f = _log_sigmoid(log_f)
    m = state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    i_w = torch.exp(log_i - m_new)
    f_w = torch.exp(log_f + m - m_new)
    k_s = k * _fp32_rsqrt(cfg.d_head)
    c_new = f_w[..., None, None] * state["C"] + i_w[..., None, None] * (
        k_s[..., :, None] * v[..., None, :])
    n_new = f_w[..., None] * state["n"] + i_w[..., None] * k_s
    num = (q[..., None, :] @ c_new)[..., 0, :]
    den = (q * n_new).sum(dim=-1).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    # on a mesh each head's output whole before the heads merge into rows
    h = constrain(h, "batch", "tp", None).reshape(B, -1)
    out = _mlstm_out(p, whole_heads(h, cfg.n_heads).to(dtype), inner_act, gate)
    return out[:, None], {"C": c_new, "n": n_new, "m": m_new, "conv": hist[:, 1:].float()}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar cell with exponential gating and head mixing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int
    d_head: int


def init_slstm(cfg: SLSTMConfig, generator, device) -> dict:
    """fp32 weights with the reference's shapes and scales: ``r_in`` ×0.5
    (per-head recurrent mixing of each gate), bias (0, 3, 0, 0) over the
    gates (i, f, z, o)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.d_head
    di = H * hd
    return {
        "w_in": dense_init((d, 4 * di), generator, device),
        "r_in": dense_init((4, H, hd, hd), generator, device) * 0.5,
        "b": torch.cat([torch.zeros((di,), device=device), 3.0 * torch.ones((di,), device=device),
                        torch.zeros((2 * di,), device=device)]),
        "w_down": dense_init((di, d), generator, device),
        "out_norm.scale": torch.ones((di,), device=device),
    }


def _slstm_step(p: dict, cfg: SLSTMConfig, state: dict, wx_t: torch.Tensor):
    """One sLSTM step in fp32.  wx_t (B, 4·di), the input projection of
    this step → (new state, h (B, H, d))."""
    B = wx_t.shape[0]
    H, d = cfg.n_heads, cfg.d_head
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    rh = torch.einsum("bhk,ghkl->bghl", h, p["r_in"])  # (B, 4, H, d)
    # on a mesh each gradient reaches these reshapes as their outputs were
    # split (the heads' split it brings back cannot flatten into rows)
    z_all = (pin_grad(wx_t.reshape(B, 4, H, d)) + rh
             + pin_grad(p["b"].reshape(1, 4, H, d)))
    # on a mesh the gate dim is made whole first (an unbind along a sharded
    # dim has no sharding strategy), and each head's cell too (its state
    # merges with the heads into (B, di) rows)
    i_t, f_t, z_t, o_t = constrain(z_all, "batch", None, "tp", None).unbind(1)
    log_i = i_t.mean(dim=-1)  # scalar gates per head (B, H)
    log_f = _log_sigmoid(f_t.mean(dim=-1))
    m_new = torch.maximum(log_f + m, log_i)
    i_w = torch.exp(log_i - m_new)[..., None]
    f_w = torch.exp(log_f + m - m_new)[..., None]
    c_new = f_w * c + i_w * torch.tanh(z_t)
    n_new = f_w * n + i_w
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}, h_new


def _whole_recurrence(p: dict) -> dict:
    """``p`` with the recurrent mixing ``r_in`` (4, H, d, d) and the gate
    bias ``b`` whole on a mesh, gathered once for the layer's steps (16 MB
    at xlstm-1.3b): their splits would reach the per-step product's
    batched flatten and the bias's reshape, which some PyTorch releases
    refuse."""
    from torch.distributed.tensor import Replicate

    if not isinstance(p["r_in"], DTensor):
        return p
    mesh = p["r_in"].device_mesh
    return {**p, **{k: p[k].redistribute(mesh, [Replicate()] * mesh.ndim)
                    for k in ("r_in", "b")}}


def init_slstm_state(cfg: SLSTMConfig, batch: int, device) -> dict:
    H, d = cfg.n_heads, cfg.d_head
    return {"c": torch.zeros((batch, H, d), device=device),
            "n": torch.zeros((batch, H, d), device=device),
            "h": torch.zeros((batch, H, d), device=device),
            "m": torch.full((batch, H), -1e30, device=device)}


def _slstm_out(p: dict, h: torch.Tensor) -> torch.Tensor:
    return rms_norm(p["out_norm.scale"], h) @ p["w_down"].to(h.dtype)


def slstm(p: dict, cfg: SLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """sLSTM over x (B, T, D) → (B, T, D): the input projection in
    ``x.dtype``, then T sequential fp32 steps."""
    dtype = x.dtype
    B, T, _ = x.shape
    wx = whole_heads((x @ p["w_in"].to(dtype)).float(), 4)  # (B, T, 4·di): the 4 gates
    p = _whole_recurrence(p)
    state = init_slstm_state(cfg, B, x.device)
    hs = []
    for t in loops.steps(T):
        state, h = _slstm_step(p, cfg, state, wx[:, t])
        hs.append(h)
    h = loops.widen(torch.stack(hs, dim=1), 1, T).reshape(B, T, -1)
    return _slstm_out(p, whole_heads(h, cfg.n_heads).to(dtype))


def slstm_decode(p: dict, cfg: SLSTMConfig, x: torch.Tensor, state: dict):
    """One-token sLSTM step.  x (B, 1, D) → (out (B, 1, D), new state)."""
    dtype = x.dtype
    wx = whole_heads((x[:, 0] @ p["w_in"].to(dtype)).float(), 4)
    state, h = _slstm_step(_whole_recurrence(p), cfg, state, wx)
    # on a mesh each head's cell whole before the heads merge into rows (the
    # state keeps the layout serving gives it)
    h = constrain(h, "batch", "tp", None).reshape(x.shape[0], -1)
    return _slstm_out(p, whole_heads(h, cfg.n_heads).to(dtype))[:, None], state
