"""Shared model layers: norms, rotary embeddings, activations, init.

Port of ``repro.models.layers`` (``rms_norm``, ``layer_norm``,
``rope_frequencies``, ``apply_rope`` with the half-split ``_rope_rotate``,
``apply_mrope``, ``activation_fn``, ``dense_init``).  Functions take plain tensors; a norm's
parameter is its (d,) scale tensor.  dtype rules are the reference's:
norms reduce in fp32 and normalise in the input's dtype, RoPE rotates in
fp32 and casts back.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "layer_norm",
    "rope_frequencies",
    "apply_rope",
    "apply_mrope",
    "activation_fn",
    "dense_init",
]


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: fp32 mean of squares, normalise in ``x.dtype``."""
    dtype = x.dtype
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dtype)
    return x * inv * scale.to(dtype)


def layer_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without bias: fp32 statistics, normalise in ``x.dtype``."""
    dtype = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps).to(dtype)
    return (x - mu.to(dtype)) * inv * scale.to(dtype)


def dense_init(
    shape: tuple[int, ...],
    generator: torch.Generator,
    device: torch.device,
    fan: int | None = None,
) -> torch.Tensor:
    """fp32 master weight: truncated normal on [−2, 2] scaled by
    1/√fan (``fan`` defaults to ``shape[0]``, the reference's fan_in)."""
    fan = shape[0] if fan is None else fan
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(1.0 / math.sqrt(fan))


def rope_frequencies(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(d_head/2,) inverse frequencies, fp32."""
    exponents = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exponents)


def _rope_rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Half-split rotation: x = [x1, x2] → [x1·cos − x2·sin, x2·cos + x1·sin]
    (not interleaved pairs), in fp32, cast back to ``x.dtype``."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE.  x (B, T, H, d_head); positions (B, T) integer."""
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., None] * inv  # (B, T, d/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return _rope_rotate(x, sin, cos)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple[int, int, int],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191).  x (B, T, H, d_head);
    positions (B, 3, T) integer (t, h, w) ids; ``sections`` the frequency
    slots of each stream, summing to d_head/2.  Slot s rotates by the
    position of its stream, picked by index (the reference's one-hot
    einsum selects the same fp32 value)."""
    d_head = x.shape[-1]
    assert sum(sections) == d_head // 2, (sections, d_head)
    inv = rope_frequencies(d_head, theta, device=x.device)
    pos = positions.float()
    B, _, T = pos.shape
    pos_sel = torch.cat([pos[:, s, :, None].expand(B, T, n) for s, n in enumerate(sections)],
                        dim=-1)  # (B, T, d/2)
    ang = pos_sel * inv
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return _rope_rotate(x, sin, cos)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(value, dtype=dtype).item()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, op by op in ``x.dtype``
    with its constants rounded to ``x.dtype``, as the reference rounds
    (``F.gelu`` evaluates in fp32 and rounds once: in bf16 it differs from
    the reference in ~40% of the values by an ulp).  The constants stay
    Python floats: a tensor made on the card would be a host copy a call."""
    c = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    k = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x**3))))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it: x·(1 / (1 + exp(−x))), op by op
    in ``x.dtype``, as the reference rounds (``F.silu`` evaluates in fp32
    and rounds once: in bf16 about one value in four of a gated FFN then
    differs by an ulp, and the differences grow over the layers)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


_ACTIVATIONS = {"gelu": _gelu, "silu": _silu, "relu2": _relu2, "relu": F.relu}


def activation_fn(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]
