"""The reference's training steps: weighted loss and its gradient, and
the first steps with a global-norm clip and AdamW (Loshchilov & Hutter)
in fp32, parameters updated in place."""
from __future__ import annotations

import torch

from perfbench.reference import model as ref

__all__ = ["loss_and_grads", "loss_and_grad_norms", "adamw_steps"]


def loss_and_grads(p: dict, s, tokens, labels, weights, mm, rows: int) -> tuple[float, dict]:
    """The weighted loss of one batch at ``p`` and its gradient by leaf."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = ref.weighted_loss(leaves, s, tokens, labels, weights, mm, rows)
    return float(loss), {k: v.grad for k, v in leaves.items()}


def loss_and_grad_norms(p: dict, s, tokens, labels, weights, mm, rows: int) -> dict:
    """The weighted loss and the norm of each gradient leaf (unclipped)."""
    loss, grads = loss_and_grads(p, s, tokens, labels, weights, mm, rows)
    return {"loss": loss, "norms": {k: float(torch.linalg.vector_norm(g))
                                    for k, g in grads.items()}}


def adamw_steps(p: dict, s, batches: list, opt: dict, mm, rows: int) -> dict:
    """Runs ``len(batches)`` steps on ``p`` (fp32 leaves, updated in place).

    ``batches``: [(tokens, labels, weights)] on p's device.  ``opt``: the
    mix's ``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay``, ``clip``
    (constant learning rate).  Returns each step's loss and the first
    step's clipped gradient norm by leaf."""
    names = list(p)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    losses, grad1 = [], None
    for t, (tokens, labels, weights) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(p, s, tokens, labels, weights, mm, rows)
        losses.append(loss)
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if opt["clip"] is not None:
                scale = torch.clamp(opt["clip"] / (norm + 1e-9), max=1.0)
                for g in grads.values():
                    g.mul_(scale)
            if grad1 is None:
                grad1 = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for k in names:
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                step = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps)
                if opt["weight_decay"]:
                    step = step + opt["weight_decay"] * p[k]
                p[k].sub_(lr * step)
            del grads
    return {"losses": losses, "grad1": grad1}
