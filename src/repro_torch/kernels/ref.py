"""Plain-torch oracles for the greedy-sweep kernels.

Port of ``repro.kernels.ref`` (``pairwise_l2_ref``, ``fl_gains_ref``,
``ce_proxy_ref``): the
dense allclose ground truth the kernels and their blockwise twins are held
against.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_l2_ref", "fl_gains_ref", "ce_proxy_ref"]


def pairwise_l2_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, m) pairwise Euclidean distances, fp32."""
    x = x.float()
    y = y.float()
    sqx = torch.sum(x * x, dim=1)[:, None]
    sqy = torch.sum(y * y, dim=1)[None, :]
    d2 = sqx + sqy - 2.0 * (x @ y.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def fl_gains_ref(
    x: torch.Tensor, e: torch.Tensor, cur_max: torch.Tensor, d_max
) -> torch.Tensor:
    """gains[c] = Σ_i relu((d_max − ‖x_i − e_c‖) − cur_max_i), fp32 (m,)."""
    sim = d_max - pairwise_l2_ref(x, e)
    return torch.sum(torch.clamp(sim - cur_max.float()[:, None], min=0.0), dim=0)


def ce_proxy_ref(hidden: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """g_t = (softmax(h_t Wᵀ) − onehot(y_t)) W, fp32 (T, D); ``unembed`` is
    vocab-major (V, D)."""
    h = hidden.float()
    w = unembed.float()
    p = torch.softmax(h @ w.T, dim=-1)
    delta = p - torch.nn.functional.one_hot(labels.long(), w.shape[0]).float()
    return delta @ w
