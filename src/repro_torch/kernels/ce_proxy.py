"""CRAIG LM proxy head: the CUDA launch wrapper and its plain-torch twin.

Port of ``repro.kernels.ce_proxy`` (``ce_proxy_pallas``).  Both compute,
for tokens with hidden states h (T, D), labels y (T,) and the vocab-major
unembedding W (V, D):

    g = softmax(h Wᵀ) W − W[y]      (T, D) fp32

with vocab columns at or past ``valid_v`` at −∞, the two matrix products
in ``compute_dtype`` with fp32 accumulation, and the softmax statistics in
fp32 (the unnormalised p is rounded to ``compute_dtype`` for the second
product and divided by its fp32 sum afterwards, as the reference does).
A label outside [0, V) subtracts nothing, as the reference's one-hot row
would be empty.

``ce_proxy_cuda`` launches the hand-written kernel ``csrc/ce_proxy.cu``
on PyTorch's current stream, checks device, dtype, shape and contiguity,
allocates its output with ``torch.empty`` and counts each launch in
:data:`LAUNCHES`.  ``ce_proxy_torch`` is the same function in plain torch,
chunked over tokens so the logits are (chunk, V) at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "COMPUTE_DTYPES", "ce_proxy_cuda", "ce_proxy_torch"]

LAUNCHES = _build.LAUNCHES

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

_ENTRY = {torch.float32: "ce_proxy_f32", torch.bfloat16: "ce_proxy_bf16"}

# Tokens per chunk of the plain twin: (chunk, V) fp32 logits at a time.
PLAIN_CHUNK = 1024

# Widest D of the bf16 kernel (CL_DMAX in csrc/ce_proxy.cu: a cluster of 8
# CTAs × 256 columns).
BF16_D_MAX = 2048
_WIDE_D_ITEM = 'ROADMAP.md queue 2, "ce_proxy at D > 2048"'


def _check(hidden, unembed, labels, valid_v):
    if hidden.device.type != "cuda":
        raise ValueError(f"the ce_proxy CUDA kernel takes CUDA tensors, got {hidden.device}")
    if hidden.dtype not in _ENTRY or unembed.dtype != hidden.dtype:
        raise ValueError(
            f"hidden and unembed must share dtype float32 or bfloat16, got "
            f"{hidden.dtype} and {unembed.dtype}"
        )
    if hidden.dim() != 2 or unembed.dim() != 2 or unembed.shape[1] != hidden.shape[1]:
        raise ValueError(
            f"hidden (T, D) and unembed (V, D) must share D, got "
            f"{tuple(hidden.shape)} and {tuple(unembed.shape)}"
        )
    T, D = hidden.shape
    V = unembed.shape[0]
    if min(T, D, V) < 1:
        raise ValueError(f"empty operand: T={T}, D={D}, V={V}")
    if max(T * D, V * D) >= 2**31:
        raise ValueError("operands past 2**31 elements are not supported")
    if not 1 <= valid_v <= V:
        raise ValueError(f"valid_v={valid_v} outside [1, V={V}]")
    if labels.shape != (T,) or labels.dtype != torch.int32:
        raise ValueError(f"labels must be (T,) int32, got {tuple(labels.shape)} {labels.dtype}")
    for t, what in ((hidden, "hidden"), (unembed, "unembed"), (labels, "labels")):
        if t.device != hidden.device:
            raise ValueError(f"{what} is on {t.device}, expected {hidden.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    return T, D, V


def ce_proxy_cuda(hidden, unembed, labels, valid_v: int) -> torch.Tensor:
    """Launch the fused proxy kernel.

    Args:
      hidden: (T, D), unembed: (V, D), both fp32 or both bf16 — the
        compute dtype (CUDA, contiguous).
      labels: (T,) int32.
      valid_v: real vocab size, 1 ≤ valid_v ≤ V.
    Returns:
      (T, D) fp32 per-token proxies.
    Raises:
      NotImplementedError: bf16 operands wider than ``BF16_D_MAX``.
    """
    if hidden.dtype == torch.bfloat16 and hidden.shape[-1] > BF16_D_MAX:
        raise NotImplementedError(
            f"the bf16 ce_proxy kernel takes D ≤ {BF16_D_MAX}, got D = "
            f"{hidden.shape[-1]} ({_WIDE_D_ITEM})"
        )
    T, D, V = _check(hidden, unembed, labels, valid_v)
    lib = _build.library("ce_proxy")
    out = torch.empty((T, D), dtype=torch.float32, device=hidden.device)
    status = getattr(lib, _ENTRY[hidden.dtype])(
        hidden.data_ptr(), unembed.data_ptr(), labels.data_ptr(), out.data_ptr(),
        T, D, V, int(valid_v), torch.cuda.current_stream(hidden.device).cuda_stream,
    )
    _build.check(status, "ce_proxy")
    LAUNCHES["ce_proxy"] += 1
    return out


def ce_proxy_torch(
    hidden, unembed, labels, valid_v: int, compute_dtype: torch.dtype,
    *, chunk: int = PLAIN_CHUNK,
) -> torch.Tensor:
    """Plain twin of :func:`ce_proxy_cuda` on any device: the same
    function, ``chunk`` tokens at a time.  Products of ``compute_dtype``
    values are exact in fp32, so widening both operands and multiplying in
    fp32 is the compute dtype with fp32 accumulation."""
    T, D = hidden.shape
    V = unembed.shape[0]
    w = unembed.to(compute_dtype).float()
    out = torch.empty((T, D), dtype=torch.float32, device=hidden.device)
    for lo in range(0, T, chunk):
        h = hidden[lo:lo + chunk].to(compute_dtype).float()
        z = h @ w.T
        if valid_v < V:
            z[:, valid_v:] = float("-inf")
        m = z.amax(dim=1, keepdim=True)
        p = torch.exp(z - m)
        l = p.sum(dim=1, keepdim=True)
        acc = p.to(compute_dtype).float() @ w
        y = labels[lo:lo + chunk].long()
        ok = (y >= 0) & (y < V)
        wy = torch.where(ok[:, None], w[torch.where(ok, y, 0)], 0.0)
        out[lo:lo + chunk] = acc / l - wy
    return out
