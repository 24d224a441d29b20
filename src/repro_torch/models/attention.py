"""Causal self-attention: GQA/MQA/MHA with RoPE or M-RoPE, qk-norm, QKV bias, sliding
window, and KV-cache decoding.

Port of ``repro.models.attention``: the projections into (d, H, hd)
(``_project_qkv``, with qk-norm after the projection and before RoPE),
the GQA head-group repeat (``_repeat_kv``), the dense path
(``_dense_attention``) and the flash-style blockwise path
(``_blockwise_attention``, online softmax over KV chunks; chunks wholly in
a query chunk's future, or wholly older than its window, are skipped),
taken above ``blockwise_threshold`` or, with a window, above twice the
window.  ``window`` makes a layer sliding-window attention (Griffin's
``local_attn``): query i sees keys (i − window, i].

Decoding keeps a bf16 KV cache (B, S, KV, hd) per layer
(``init_kv_cache``): S = max_len, or a ring of S = min(window, max_len)
slots for a windowed layer, position p in slot p mod S.
``decode_attention`` writes the new token's k/v into its slot in place
(the reference's donated buffers) and attends grouped queries
(B, KV, G, hd) to the cache without repeating it.  These are plain
tensor code in the reference too (no Pallas kernel), so they are plain
torch here.  With ``mrope_sections`` (Qwen2-VL) q and k rotate by
M-RoPE over (B, 3, T) positions; a decode step advances the three
streams together.

Parameters of one layer's mixer: ``wq`` (d, H, hd), ``wk``/``wv``
(d, KV, hd), ``wo`` (H, hd, d), optional ``bq``/``bk``/``bv`` and
``q_norm``/``k_norm`` scales (hd,).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.annotate import constrain, per_shard, pin_grad, whole_heads
from repro_torch.models import loops
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init, rms_norm

__all__ = ["AttentionConfig", "init_attention", "attention", "init_kv_cache",
           "decode_attention"]

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] | None = None  # Qwen2-VL
    window: int | None = None  # sliding-window size (None = global)
    blockwise_threshold: int = 8192  # blockwise above this sequence length
    chunk_q: int = 1024
    chunk_kv: int = 1024


def init_attention(cfg: AttentionConfig, generator, device) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init((d, H * hd), generator, device).reshape(d, H, hd),
        "wk": dense_init((d, KV * hd), generator, device).reshape(d, KV, hd),
        "wv": dense_init((d, KV * hd), generator, device).reshape(d, KV, hd),
        "wo": dense_init((H * hd, d), generator, device).reshape(H, hd, d),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), device=device)
        p["bk"] = torch.zeros((KV, hd), device=device)
        p["bv"] = torch.zeros((KV, hd), device=device)
    if cfg.qk_norm:
        p["q_norm.scale"] = torch.ones((hd,), device=device)
        p["k_norm.scale"] = torch.ones((hd,), device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('btd,dhk->bthk') as one matrix product in ``x.dtype``."""
    d, h, k = w.shape
    # on a mesh the gradient reaches the split back into h·k as the forward
    # left it, whatever split the heads take next
    return pin_grad(whole_heads(x @ w.to(x.dtype).reshape(d, h * k), h).unflatten(-1, (h, k)))


def _project_qkv(p: dict, cfg: AttentionConfig, x, positions):
    """x (B, T, D) → q (B, T, H, hd), k/v (B, T, KV, hd), RoPE (or
    M-RoPE) applied."""
    dtype = x.dtype
    q = constrain(_proj(x, p["wq"]), "batch", None, "tp", None)
    # KV heads shard over model only when exactly divisible; otherwise they
    # replicate (they are small), so the GQA repeat below stays local
    k = constrain(_proj(x, p["wk"]), "batch", None, "tp", None, strict=True)
    v = constrain(_proj(x, p["wv"]), "batch", None, "tp", None, strict=True)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm.scale"], q)
        k = rms_norm(p["k_norm.scale"], k)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, KV, hd) → (B, T, KV·n_rep, hd) by head-group broadcast."""
    if n_rep == 1:
        return k
    b, t, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, kv, n_rep, hd).reshape(b, t, kv * n_rep, hd)


def _scale(cfg: AttentionConfig) -> float:
    return float(1.0 / torch.sqrt(torch.tensor(cfg.d_head, dtype=torch.float32)))


def _dense_attention(q, k, v, scale: float, causal_offset: int = 0,
                     window: int | None = None):
    """q (B,Tq,H,hd), k/v (B,Tk,H,hd); query i attends keys ≤ i + offset
    (and, with a window, > i + offset − window)."""
    Tq, Tk = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    qi = torch.arange(Tq, device=q.device)[:, None] + causal_offset
    ki = torch.arange(Tk, device=q.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask &= ki > qi - window
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def _blockwise_attention(q, k, v, scale: float, cfg: AttentionConfig):
    """Online softmax over KV chunks (exact; chunks that lie wholly in a
    query chunk's future, or wholly older than its window, are skipped)."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    cq = math.gcd(min(cfg.chunk_q, Tq), Tq)
    ckv = math.gcd(min(cfg.chunk_kv, Tk), Tk)
    outs = []
    for qi in range(Tq // cq):
        qc = q[:, qi * cq:(qi + 1) * cq]
        m = torch.full((B, H, cq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((B, H, cq, 1), device=q.device)
        acc = torch.zeros((B, H, cq, hd), device=q.device)
        qpos = qi * cq + torch.arange(cq, device=q.device)[:, None]
        # chunks wholly in the future, or wholly older than the window of
        # every query here, are skipped
        kjs = [kj for kj in range(Tk // ckv) if kj * ckv <= (qi + 1) * cq - 1 and not (
            cfg.window is not None and (kj + 1) * ckv <= qi * cq - cfg.window)]
        for j in loops.steps(len(kjs)):
            kj = kjs[j]
            ks = k[:, kj * ckv:(kj + 1) * ckv]
            vs = v[:, kj * ckv:(kj + 1) * ckv]
            s = torch.einsum("bqhk,bshk->bhqs", qc, ks).float() * scale
            kpos = kj * ckv + torch.arange(ckv, device=q.device)[None, :]
            mask = kpos <= qpos
            if cfg.window is not None:
                mask &= kpos > qpos - cfg.window
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new) * mask  # all-masked rows: exp(0) → 0
            corr = torch.exp(torch.clamp(m - m_new, max=0.0))
            l = l * corr + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhqs,bshk->bhqk", p.to(q.dtype), vs)
            acc = acc * corr + pv.float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))  # (B, cq, H, hd)
    return torch.cat(outs, dim=1)


def attention(p: dict, cfg: AttentionConfig, x: torch.Tensor, positions: torch.Tensor):
    """Causal self-attention over x (B, T, D) → (B, T, D)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    # the repeat's backward merges the head split back into KV groups: on a
    # mesh its gradient arrives as the repeat left the heads
    k = constrain(pin_grad(_repeat_kv(k, n_rep)), "batch", None, "tp", None)
    v = constrain(pin_grad(_repeat_kv(v, n_rep)), "batch", None, "tp", None)
    scale = _scale(cfg)
    if T > cfg.blockwise_threshold or (cfg.window is not None and T > 2 * cfg.window):
        out = per_shard(lambda q, k, v: _blockwise_attention(q, k, v, scale, cfg), q, k, v)
    else:
        out = per_shard(lambda q, k, v: _dense_attention(q, k, v, scale, 0, cfg.window), q, k, v)
    # on a mesh, heads split evenly or not at all into the flatten before
    # the output projection (DTensor flattens no uneven split)
    out = constrain(out, "batch", None, "tp", None, strict=True)
    H, hd, d = p["wo"].shape
    return whole_heads(out.reshape(B, T, H * hd), H) @ p["wo"].to(x.dtype).reshape(H * hd, d)


# ---------------------------------------------------------------------------
# decoding with a KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: AttentionConfig, batch: int, max_len: int, device,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """Zeroed KV cache {k, v} (batch, S, KV, hd); S = max_len, or a ring
    of min(window, max_len) slots for a windowed layer."""
    size = max_len if cfg.window is None else min(cfg.window, max_len)
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: dict, cfg: AttentionConfig, x: torch.Tensor, cache: dict, pos: int):
    """One-token decode.  x (B, 1, D) at absolute position ``pos`` (a host
    integer, the same for every row) → (out (B, 1, D), cache).

    The new k/v go into slot ``pos mod S`` of the cache in place; the
    returned cache holds the same tensors."""
    B = x.shape[0]
    # text-only decode: all three M-RoPE streams advance together
    shape = (B, 1) if cfg.mrope_sections is None else (B, 3, 1)
    positions = torch.full(shape, pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    size = cache["k"].shape[1]
    slot = pos % size
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)

    # grouped-query attention without repeating the cache
    KV, hd = cfg.n_kv_heads, cfg.d_head
    G = cfg.n_heads // KV
    # on a mesh the head dim goes over model before the heads split into
    # (KV, G) groups, which a split of the heads may not follow
    q1 = constrain(q[:, 0], "batch", None, "tp", strict=True)
    q5 = constrain(q1.reshape(B, KV, G, hd), "batch", None, None, "tp", strict=True)
    k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    # on a mesh the scores' partial sums over the split head dim reduce here
    # (the step's one collective), so the value product's batch stays whole
    scores = constrain(torch.einsum("bkgh,bskh->bkgs", q5, k), "batch", None, None, None)
    scores = scores.float() * _scale(cfg)
    s_idx = torch.arange(size, device=x.device)
    if cfg.window is None:
        valid = s_idx <= pos  # S = max_len: no wrap
    else:
        # ring: slot s holds position cur − ((cur − s) mod S) ∈ (cur − S, cur];
        # valid once written (remainder, not fmod: the wrap needs a
        # non-negative residue)
        valid = pos - torch.remainder(pos - s_idx, size) >= 0
    scores = torch.where(valid, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    # on a mesh the head dim is gathered before it merges with the heads (a
    # split inner dim would merge into a strided split)
    out = constrain(torch.einsum("bkgs,bskh->bkgh", probs, v), "batch", None, None, None)
    out = whole_heads(out.reshape(B, 1, KV * G * hd), KV * G)
    H, hd_, d = p["wo"].shape
    return out @ p["wo"].to(x.dtype).reshape(H * hd_, d), cache
