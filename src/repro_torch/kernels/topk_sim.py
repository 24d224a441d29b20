"""Top-k similarity graph: the CUDA launch wrapper and its plain-torch twin.

Port of ``repro.kernels.topk_sim`` (``topk_sim_pallas``).  The TPU kernel
becomes ``csrc/topk_sim.cu``, bound through :mod:`._build`; beside it sits
the plain version, the reference's jnp ``topk_graph`` scan
(``repro/core/engines/sparse.py:78-105``): blocked columns merged into a
running per-row top-k, ties to the lower column.
:mod:`repro_torch.kernels.ops` chooses.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fl_gains import _require, _stream

__all__ = ["topk_sim_cuda", "topk_sim_torch"]

LAUNCHES = _build.LAUNCHES


def topk_sim_cuda(x, sq, d_max, k: int):
    """Launch the kernel: each row's k largest d_max − ‖x_i − x_j‖.

    Args:
      x: (n, d) fp32 (CUDA, contiguous); sq: (n,) fp32 squared row norms.
      d_max: 0-d fp32 tensor on the same card.
      k: neighbours per row, 1 ≤ k ≤ n (k ≤ 128 keeps each row's list in
        its warp's registers, larger k in the rows of the outputs).
    Returns:
      (vals (n, k) fp32 descending, idx (n, k) int32), ties to the lower
      column.
    """
    if x.device.type != "cuda":
        raise ValueError(f"the topk_sim CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    if min(n, d) < 1 or n * d >= 2**31:
        raise ValueError(f"unsupported operand shape n={n}, d={d}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, n={n}]")
    dev = x.device
    _require(x, "x", torch.float32, (n, d), dev)
    _require(sq, "sq", torch.float32, (n,), dev)
    _require(d_max, "d_max", torch.float32, (), dev)
    lib = _build.library("topk_sim")
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    status = lib.topk_sim_f32(
        x.data_ptr(), sq.data_ptr(), d_max.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), n, d, k, _stream(dev),
    )
    _build.check(status, "topk_sim")
    LAUNCHES["topk_sim"] += 1
    return vals, idx


def topk_sim_torch(x, sq, d_max, k: int, *, block_m: int = 2048):
    """Plain twin of :func:`topk_sim_cuda`: (n × block_m) similarity tiles
    in column order, each merged into the running top-k of [carry | tile]
    in (value desc, column asc) order.  The carry holds lower columns in
    that order and the tile's columns ascend, so a stable descending sort
    of [carry | tile] keeps, among equal values, the lower column, at the
    k-th place too: the rule of ``lax.top_k`` and of the kernel.  That sort
    runs only on the rows whose k-th and (k+1)-th values tie; on the others
    the k largest are one set, taken by ``torch.topk`` and put in that
    order."""
    n = x.shape[0]
    x = x.float()
    vals = torch.full((n, k), -1e30, dtype=torch.float32, device=x.device)
    idx = torch.zeros((n, k), dtype=torch.int64, device=x.device)
    for lo in range(0, n, block_m):
        hi = min(lo + block_m, n)
        d2 = (sq[:, None] + sq[None, lo:hi]) - 2.0 * (x @ x[lo:hi].T)
        sim = d_max - torch.sqrt(torch.clamp(d2, min=0.0))
        cols = torch.arange(lo, hi, device=x.device).expand(n, hi - lo)
        cat_v = torch.cat([vals, sim], dim=1)
        cat_i = torch.cat([idx, cols], dim=1)
        top_v, pos = torch.topk(cat_v, k + 1, dim=1)
        tie = (top_v[:, k - 1] == top_v[:, k]).nonzero().squeeze(1)
        vals, idx = top_v[:, :k], torch.gather(cat_i, 1, pos[:, :k])
        # (value desc, column asc): sort by column, then stably by value
        order = torch.argsort(idx, dim=1)
        vals, idx = torch.gather(vals, 1, order), torch.gather(idx, 1, order)
        order = torch.sort(vals, dim=1, descending=True, stable=True).indices
        vals, idx = torch.gather(vals, 1, order), torch.gather(idx, 1, order)
        if tie.numel():  # an exact tie at the k-th place
            tv, ti = cat_v[tie], cat_i[tie]
            p = torch.sort(tv, dim=1, descending=True, stable=True).indices[:, :k]
            vals[tie], idx[tie] = torch.gather(tv, 1, p), torch.gather(ti, 1, p)
    return vals, idx.to(torch.int32)
