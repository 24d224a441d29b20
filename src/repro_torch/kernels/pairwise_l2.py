"""Pairwise L2 distances: the CUDA launch wrapper and its plain-torch twin.

Port of ``repro.kernels.pairwise_l2`` (``pairwise_l2_pallas``).  The TPU
kernel becomes ``csrc/pairwise_l2.cu``, bound through :mod:`._build`.  In
the port it computes the sparse engine's exact γ assignment
(``core/engines/sparse.py::_blocked_assignment``), which the reference
runs on the host in numpy.  :mod:`repro_torch.kernels.ops` chooses between
the kernel and the twin.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fl_gains import _require, _stream

__all__ = ["pairwise_l2_cuda", "pairwise_l2_torch"]

LAUNCHES = _build.LAUNCHES


def pairwise_l2_cuda(x, y, sqx, sqy) -> torch.Tensor:
    """Launch the kernel: out[i, j] = sqrt(max((sqx_i + sqy_j) − 2·x_i·y_j, 0)).

    Args:
      x: (n, d), y: (m, d) fp32 (CUDA, contiguous).
      sqx (n,), sqy (m,): fp32 squared row norms.
    Returns:
      (n, m) fp32 distances.
    """
    if x.device.type != "cuda":
        raise ValueError(f"the pairwise_l2 CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x (n, d) and y (m, d) must share d, got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    n, d = x.shape
    m = y.shape[0]
    if min(n, m, d) < 1:
        raise ValueError(f"empty operand: n={n}, m={m}, d={d}")
    if max(n * d, m * d) >= 2**31:
        raise ValueError(f"operands too large for the kernel: n={n}, m={m}, d={d}")
    dev = x.device
    _require(x, "x", torch.float32, (n, d), dev)
    _require(y, "y", torch.float32, (m, d), dev)
    _require(sqx, "sqx", torch.float32, (n,), dev)
    _require(sqy, "sqy", torch.float32, (m,), dev)
    lib = _build.library("pairwise_l2")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    status = lib.pairwise_l2_f32(
        x.data_ptr(), y.data_ptr(), sqx.data_ptr(), sqy.data_ptr(),
        out.data_ptr(), n, m, d, _stream(dev),
    )
    _build.check(status, "pairwise_l2")
    LAUNCHES["pairwise_l2"] += 1
    return out


def pairwise_l2_torch(x, y, sqx, sqy) -> torch.Tensor:
    """Plain twin of :func:`pairwise_l2_cuda` (``ref.py:14``): the same
    formula with one matrix product."""
    d2 = (sqx[:, None] + sqy[None, :]) - 2.0 * (x.float() @ y.float().T)
    return torch.sqrt(torch.clamp(d2, min=0.0))
