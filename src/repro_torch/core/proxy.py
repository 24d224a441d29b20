"""Gradient-proxy features for CRAIG (paper Eq. 9 and Eq. 16).

Port of ``repro.core.proxy`` (``convex_feature_proxy``,
``classifier_last_layer_proxy``).  The LM proxy and exact per-example
gradients come with the models (ROADMAP.md queue 1, slice 2).
"""
from __future__ import annotations

import torch

__all__ = ["convex_feature_proxy", "classifier_last_layer_proxy"]


def convex_feature_proxy(
    x, normalize: bool = False, *, device: str | torch.device | None = None
) -> torch.Tensor:
    """Proxy for convex losses (Eq. 9): the raw feature vectors.

    ‖∇f_i(w) − ∇f_j(w)‖ ≤ O(‖w‖)·‖x_i − x_j‖ for same-label pairs, so
    selection on x-space distances upper-bounds gradient distances up to a
    constant that scales ε but not the argmin subset.

    Args:
      x: (n, d) numpy array or tensor.
      normalize: unit-normalize rows.
      device: where the features go; a tensor's own device by default.
    """
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if normalize:
        x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)
    return x


def classifier_last_layer_proxy(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Softmax+CE last-layer gradient proxy (§3.4): p − y, per example.

    Args:
      logits: (n, num_classes).
      labels: (n,) int class ids.
    Returns:
      (n, num_classes) float32 proxy features.
    """
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=logits.device)
    p = torch.softmax(logits.float(), dim=-1)
    y = torch.nn.functional.one_hot(labels, logits.shape[-1]).to(torch.float32)
    return p - y
