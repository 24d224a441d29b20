"""Plain-torch oracles for the greedy-sweep kernels.

Port of ``repro.kernels.ref`` (``pairwise_l2_ref``, ``fl_gains_ref``,
``ce_proxy_ref``, ``topk_sim_ref``), plus ``fl_replay_ref``, the dense
per-step replay of the reference's ``streaming_result``: the dense
allclose ground truth the kernels and their blockwise twins are held
against.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_l2_ref", "fl_gains_ref", "ce_proxy_ref", "topk_sim_ref",
           "fl_replay_ref"]


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


def topk_sim_ref(x: torch.Tensor, k: int, d_max) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense top-k similarity rows: vals (n, k) descending, idx (n, k) int32.

    sim[i, j] = d_max − ‖x_i − x_j‖; ties to the lower column (a stable
    sort, as ``lax.top_k``)."""
    sim = d_max - pairwise_l2_ref(x, x)
    vals, idx = torch.sort(sim, dim=1, descending=True, stable=True)
    return vals[:, :k].float(), idx[:, :k].to(torch.int32)


def fl_replay_ref(x: torch.Tensor, e: torch.Tensor, valid: torch.Tensor,
                  cur0: torch.Tensor, d_max):
    """Sequential FL replay of the candidates ``e`` in row order, one column
    at a time as the dense ``streaming_result`` scan does.

    gains[t] = Σ_i relu(s_it − cur_i) before cur_i = max(cur_i, s_it), with
    s = d_max − ‖x_i − e_t‖ and −1e30 for dead (``valid`` False) columns.
    Returns (gains (m,), cur (n,), best_v (n,), best_i (n,) int32): each
    row's best column, the first on ties (−1e30 and 0 if none is live)."""
    s = d_max - pairwise_l2_ref(x, e)
    s = torch.where(valid.bool()[None, :], s, torch.full_like(s, -1e30))
    cur = cur0.float()
    gains = []
    for t in range(s.shape[1]):
        gains.append(torch.sum(torch.clamp(s[:, t] - cur, min=0.0)))
        cur = torch.maximum(cur, s[:, t])
    gains = torch.stack(gains) if gains else torch.zeros((0,))
    if s.shape[1] == 0:
        return gains, cur, torch.full_like(cur, -1e30), torch.zeros_like(cur, dtype=torch.int32)
    best_v, best_i = torch.max(s, dim=1)
    return gains, cur, best_v, best_i.to(torch.int32)
