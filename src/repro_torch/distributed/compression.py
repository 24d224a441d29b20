"""Payload compression for the cross-shard and cross-process wire.

Port of ``repro.distributed.compression``.  Two int8 quantization schemes:

**Gradients** (``quantize_int8``/``dequantize_int8``/``compressed_psum``):
per-block (256) absmax scaling with error feedback.  ``compressed_psum``
returns what the reference's int8 ``all_gather`` reconstructs on every
peer, the mean of the dequantized payloads, in two forms: the
reference's, a rank's tensor and a process group (the payloads and
scales all-gathered, then summed in rank order), and the
single-process one, the per-peer tensors of one reduction in peer order.
Both sum the same way and agree bit for bit.

**Candidate-feature matrices** (``quantize_rows_int8``/
``dequantize_rows_int8``): per-row absmax scaling of a 2-D (r, d) payload,
the wire of hierarchical tree selection (``distributed.tree_select``).
Each row is one candidate's proxy vector, so an outlier feature degrades
only its own candidate; one-shot payloads carry no error feedback.

The codes equal the reference's: ``max|x| / 127`` and ``x / scale`` are
true divisions, as XLA computes them (a multiply by the reciprocal moves a
value at a .5 boundary by one code), and ``torch.round`` rounds half to
even like ``jnp.round``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.distributed.collectives import group_size, resolve

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "quantize_rows_int8",
    "dequantize_rows_int8",
    "compressed_psum",
    "make_error_feedback",
]

_BLOCK = 256


def _scales(absmax: torch.Tensor) -> torch.Tensor:
    # a 0-dim tensor on absmax's device, not a Python number: on a card
    # PyTorch divides by a host scalar as a multiply by its reciprocal
    return absmax / torch.tensor(127.0, device=absmax.device) + 1e-12


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale[:, None]), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) → (int8 payload (n_blocks, 256), fp32 scales (n_blocks,))."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = _scales(torch.amax(torch.abs(blocks), dim=1))
    return _codes(blocks, scale), scale


def dequantize_int8(
    q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...]
) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: fp32 of ``shape``."""
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, d) feature matrix → (int8 payload (r, d), fp32 scales (r,)).

    Row i is quantized with scale_i = max|x_i|/127 (+1e-12), so the
    round-trip error of a row is at most scale_i/2 plus fp32 rounding.
    bf16 inputs are widened to fp32 first.
    """
    if x.dim() != 2:
        raise ValueError(
            f"quantize_rows_int8 expects a 2-D (r, d) feature matrix, got "
            f"shape {tuple(x.shape)} — use quantize_int8 for arbitrary-shape "
            "gradient payloads"
        )
    xf = x.float()
    scale = _scales(torch.amax(torch.abs(xf), dim=1))
    return _codes(xf, scale), scale


def dequantize_rows_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows_int8`: (r, d) fp32 features."""
    return q.float() * scale[:, None]


def _payload_mean(payloads, shape: tuple, dev) -> torch.Tensor:
    """The dequantized (int8, scales) payloads summed in order on ``dev``,
    cut to ``shape``, over their count."""
    total = None
    for q, s in payloads:
        part = q.to(dev).float() * s.to(dev)[:, None]
        total = part if total is None else total + part
    size = 1
    for s in shape:
        size *= s
    return total.reshape(-1)[:size].reshape(shape) / len(payloads)


def compressed_psum(xs: torch.Tensor | Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """Mean over peers with an int8 payload on the wire.

    Two forms:

    * ``compressed_psum(x, group)``, the reference's: this rank's tensor
      ``x`` and a process group (``distributed.collectives``' groups); the
      int8 payloads and their scales are all-gathered and summed in rank
      order, over the group size.  Every rank of the group calls it.
    * ``compressed_psum(xs)``: ``xs`` holds one tensor per peer, in peer
      order (one process driving every peer); each is quantized, and the
      dequantized payloads are summed in peer order on the first peer's
      device, over the peer count.
    """
    if isinstance(xs, torch.Tensor):
        if group is None:
            raise ValueError("compressed_psum of one tensor needs its group")
        import torch.distributed._functional_collectives as funcol

        n = group_size(group)
        q, s = quantize_int8(xs)
        g = resolve(group)
        qs = funcol.wait_tensor(funcol.all_gather_tensor(q, 0, g)).reshape(n, *q.shape)
        ss = funcol.wait_tensor(funcol.all_gather_tensor(s, 0, g)).reshape(n, *s.shape)
        return _payload_mean(list(zip(qs, ss)), tuple(xs.shape), xs.device)
    if not xs:
        raise ValueError("compressed_psum needs at least one peer")
    shape = tuple(xs[0].shape)
    for x in xs:
        if tuple(x.shape) != shape:
            raise ValueError(
                f"compressed_psum: peer shapes differ ({tuple(x.shape)} vs {shape})"
            )
    return _payload_mean([quantize_int8(x) for x in xs], shape, xs[0].device)


def make_error_feedback(grad_like: dict):
    """Returns (init_residual(), apply(grads, residual) → (delivered, res')).

    ``grad_like`` is a dict of tensors (the port's parameter trees are flat
    dicts).  ``apply`` adds the carried residual, quantizes and
    dequantizes (what the wire delivers), and stores the new residual =
    input − delivered.
    """

    def init_residual():
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grad_like.items()}

    def apply(grads, residual):
        delivered, new_res = {}, {}
        for k, g in grads.items():
            total = g.float() + residual[k]
            q, s = quantize_int8(total)
            d = dequantize_int8(q, s, tuple(total.shape))
            delivered[k] = d
            new_res[k] = total - d
        return delivered, new_res

    return init_residual, apply
