"""Dense decoder (Qwen2 / Granite 3.0 block) in plain PyTorch.

From the published description: token embedding; per layer RMSNorm →
grouped-query attention with rotary embeddings (the half-split rotation),
optional QKV bias, causal softmax at 1/√head_dim → output projection →
residual; RMSNorm → SwiGLU FFN (gate and up projections side by side in
one (d, 2·d_ff) matrix, the gate first) → residual; a final RMSNorm and
the unembedding over the real vocabulary.  Parameters are read in the
port's layout (the benchmark makes them; ``perfbench.model_shape``).

Departures from the published models, shared with the program: the
configuration file's ``as_run`` lists them (for Granite 3.0, no scalar
multipliers and an untied head).
"""
from __future__ import annotations

import math

import torch

__all__ = ["no_tf32", "Matmul", "hidden", "logits", "per_example_loss", "weighted_loss",
           "proxy_features"]

E4M3_MAX = 448.0


def no_tf32() -> None:
    """fp32 products in fp32 (no TF32), for every later product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _FakeE4M3(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale (amax → 448);
    the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Matmul:
    """Every matrix product of the reference: fp32, or with both operands
    rounded to fp8 first (the control)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _FakeE4M3.apply(x) if self.precision == "fp8" else x

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (B, T, H, hd); position t rotates pair (i, i + hd/2) by t·θ^(−2i/hd)."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(p: dict, i: int, s, x, mm: Matmul):
    B, T, d = x.shape
    H, KV, hd = s.n_heads, s.n_kv_heads, s.head_dim
    pre = f"layers.{i}."
    h = _rms_norm(x, p[pre + "norm1.scale"], s.norm_eps)
    q = mm(h, p[pre + "mixer.wq"].reshape(d, H * hd)).view(B, T, H, hd)
    k = mm(h, p[pre + "mixer.wk"].reshape(d, KV * hd)).view(B, T, KV, hd)
    v = mm(h, p[pre + "mixer.wv"].reshape(d, KV * hd)).view(B, T, KV, hd)
    if s.qkv_bias:
        q = q + p[pre + "mixer.bq"]
        k = k + p[pre + "mixer.bk"]
        v = v + p[pre + "mixer.bv"]
    q, k = _rope(q, s.rope_theta), _rope(k, s.rope_theta)
    rep = H // KV  # query head j reads key/value head j // rep
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, hd)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    att = mm(probs, v).transpose(1, 2).reshape(B, T, H * hd)
    x = x + mm(att, p[pre + "mixer.wo"].reshape(H * hd, d))
    h = _rms_norm(x, p[pre + "norm2.scale"], s.norm_eps)
    gate, up = mm(h, p[pre + "ffn.w_in"]).chunk(2, dim=-1)
    return x + mm(torch.nn.functional.silu(gate) * up, p[pre + "ffn.w_out"])


def hidden(p: dict, s, tokens: torch.Tensor, mm: Matmul) -> torch.Tensor:
    """(B, T) tokens → (B, T, d) fp32 states after the final norm."""
    x = p["embed"][tokens.long()]
    for i in range(s.n_layers):
        x = _layer(p, i, s, x, mm)
    return _rms_norm(x, p["final_norm.scale"], s.norm_eps)


def _head(p: dict, s) -> torch.Tensor:
    """The (V, d) unembedding over the real vocabulary."""
    return (p["embed"] if s.tied else p["unembed"])[: s.vocab_size]


def logits(p: dict, s, h: torch.Tensor, mm: Matmul) -> torch.Tensor:
    return mm(h, _head(p, s).T)


def per_example_loss(p: dict, s, tokens, labels, mm: Matmul) -> torch.Tensor:
    """(B,) mean next-token cross-entropy of each sequence."""
    z = logits(p, s, hidden(p, s, tokens, mm), mm)
    ce = torch.logsumexp(z, dim=-1) - torch.gather(z, -1, labels.long()[..., None])[..., 0]
    return ce.mean(dim=-1)


def weighted_loss(p: dict, s, tokens, labels, weights, mm: Matmul, rows: int) -> torch.Tensor:
    """Σ_b w_b·loss_b / max(Σ w, 1e-6) over the batch (paper Eq. 20's
    per-element step sizes as loss weights), with its gradient accumulated
    ``rows`` sequences at a time.  Returns the loss (detached)."""
    denom = torch.clamp(weights.sum(), min=1e-6)
    total = torch.zeros((), device=weights.device)
    for lo in range(0, tokens.shape[0], rows):
        part = (per_example_loss(p, s, tokens[lo:lo + rows], labels[lo:lo + rows], mm)
                * weights[lo:lo + rows]).sum() / denom
        part.backward()
        total += part.detach()
    return total


@torch.no_grad()
def proxy_features(p: dict, s, tokens, labels, mm: Matmul, rows: int) -> torch.Tensor:
    """(B, d) CRAIG proxies: per sequence, the mean over tokens of the
    loss gradient with respect to the unembedding's input,
    (softmax(h Wᵀ) − onehot(y)) W, over the real vocabulary."""
    w = _head(p, s)
    out = []
    for lo in range(0, tokens.shape[0], rows):
        h = hidden(p, s, tokens[lo:lo + rows], mm)
        prob = torch.softmax(mm(h, w.T), dim=-1)
        g = mm(prob, w) - w[labels[lo:lo + rows].long()]
        out.append(g.mean(dim=1))
    return torch.cat(out)
