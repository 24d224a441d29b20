"""Griffin's recurrent block: RG-LRU with a temporal convolution.

Port of the RG-LRU half of ``repro.models.recurrent`` (``RGLRUConfig``,
``init_griffin_block``, ``_rglru_scan``, ``_causal_conv``,
``griffin_block``, ``init_griffin_state``, ``griffin_decode``); mLSTM and
sLSTM are not ported (ROADMAP.md queue 1, item 6).  The block has a
parallel form for training and prefill and an O(1) per-token decode form
with an explicit state, over the same weights.

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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation_fn, dense_init

__all__ = ["RGLRUConfig", "init_griffin_block", "griffin_block", "init_griffin_state",
           "griffin_decode"]

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness constant
_gelu = activation_fn("gelu")  # jax.nn.gelu's default (tanh) form


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
    r_g = torch.sigmoid(u32 @ p["w_a"] + p["b_a"])
    i_g = torch.sigmoid(u32 @ p["w_i"] + p["b_i"])
    a = torch.exp(_C_RGLRU * r_g * F.logsigmoid(p["lam"]))
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
    K, T = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pads[:, k:k + T] * w[k]
    return out


def griffin_block(p: dict, cfg: RGLRUConfig, x: torch.Tensor) -> torch.Tensor:
    """Griffin recurrent block over x (B, T, D): gate ⊙ RG-LRU(conv(proj(x)))
    → out projection, in ``x.dtype`` (the scan in fp32)."""
    dtype = x.dtype
    gate = _gelu(x @ p["w_gate"].to(dtype))
    u = _causal_conv(p["conv"].to(dtype), x @ p["w_x"].to(dtype))
    h = _rglru_scan(p, u)
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
