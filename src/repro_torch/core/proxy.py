"""Gradient-proxy features for CRAIG (paper Eq. 9 and Eq. 16).

Port of ``repro.core.proxy`` (``convex_feature_proxy``,
``classifier_last_layer_proxy``, ``lm_unembed_input_proxy``,
``exact_per_example_grads``).  The LM proxy takes the port's vocab-major
(V, D) unembedding; the fused kernel path is ``kernels.ops.ce_proxy``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.annotate import unsharded

__all__ = [
    "convex_feature_proxy",
    "classifier_last_layer_proxy",
    "lm_unembed_input_proxy",
    "exact_per_example_grads",
]


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


@torch.no_grad()
def lm_unembed_input_proxy(
    hidden: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    chunk: int = 512,
    valid_v: int | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Pooled gradient w.r.t. the unembedding input, per sequence.

    g_b = Σ_t m_{b,t} (softmax(h_{b,t} Wᵀ) − onehot(y_{b,t})) W / max(Σ_t m_{b,t}, 1)

    over sequence chunks of ``chunk`` tokens, so the (B, chunk, V) logits
    are transient.  As in the reference, both products run in
    ``compute_dtype`` (their outputs rounded to it), softmax and the pooled
    accumulator in fp32.  The reference pads T to a chunk multiple with
    masked rows; the ragged last chunk here adds the same (zero) terms.

    Args:
      hidden: (B, T, D) final hidden states.
      unembed: (V, D) vocab-major unembedding.
      labels: (B, T) integer targets.
      mask: optional (B, T) {0, 1} validity mask.
      valid_v: real vocab size when W is padded; columns past it are −∞.
    Returns:
      (B, D) fp32 proxy features.
    """
    B, T, D = hidden.shape
    V = unembed.shape[0]
    if mask is None:
        mask = torch.ones((B, T), device=hidden.device)
    mask = mask.float()
    # on a mesh the unembedding gathered over data for the products (ZeRO-3)
    w = unsharded({"unembed": unembed})["unembed"].to(compute_dtype)
    pad_bias = None
    if valid_v is not None and valid_v < V:
        pad_bias = torch.where(torch.arange(V, device=hidden.device) < valid_v, 0.0, -1e30)
    acc = torch.zeros((B, D), device=hidden.device)
    for lo in range(0, T, chunk):
        h, y, m = hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk], mask[:, lo:lo + chunk]
        logits = (h.to(compute_dtype) @ w.T).float()
        if pad_bias is not None:
            logits = logits + pad_bias
        delta = torch.softmax(logits, dim=-1)
        del logits
        y = y.long()
        ok = (y >= 0) & (y < V)  # one_hot of an out-of-range label is empty
        if isinstance(delta, DTensor):
            # on a mesh the one-hot subtracted whole (a scatter along the
            # vocab has no sharding strategy); x − 0 = x, so equal values
            hit = torch.arange(V, device=hidden.device) == y[..., None]
            delta = delta - torch.where(hit, ok.float()[..., None], 0.0)
        else:
            delta.scatter_add_(-1, torch.where(ok, y, 0)[..., None], -ok.float()[..., None])
        g = (delta.to(compute_dtype) @ w).float()
        acc = acc + torch.einsum("bcd,bc->bd", g, m)
    denom = torch.clamp(mask.sum(dim=1), min=1.0)
    return acc / denom[:, None]


def exact_per_example_grads(
    loss_fn: Callable[..., torch.Tensor],
    params,
    xs: torch.Tensor,
    ys: torch.Tensor,
) -> torch.Tensor:
    """Oracle: exact flattened per-example gradients, (n, P) fp32.

    ``loss_fn(params, x_i, y_i)`` returns one example's scalar loss;
    ``params`` is a tensor or a dict of tensors (flattened in sorted-key
    order, as the reference's pytree leaves are).
    """
    grad_fn = torch.func.grad(loss_fn)

    def flat(x, y):
        g = grad_fn(params, x, y)
        leaves = [g[k] for k in sorted(g)] if isinstance(g, dict) else [g]
        return torch.cat([l.reshape(-1) for l in leaves]).float()

    return torch.func.vmap(flat)(xs, ys)
