"""The yardstick's arithmetic: published peaks, model FLOPs and the
``ce_proxy`` kernel's operations and bytes, all from shapes.

Model FLOPs count the work a cell needs, whatever implements it: a train
step is 6·N·tokens plus causal attention (forward 2·B·T²·H·hd a layer:
the two products over the half of the score matrix a causal mask keeps,
backward twice that); an extract forward is 2·N·tokens without the head
plus the attention forward; the proxy head is 4·T·D·V (the logits and
the softmax-weighted sum of the unembedding).  N counts matrix-product
parameters (``Shape.matmul_params``); recomputation is not counted.
"""
from __future__ import annotations

from perfbench.model_shape import Shape

__all__ = ["H100_PEAKS", "peaks", "train_step_flops", "extract_flops", "ce_proxy_bound_s"]

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
H100_PEAKS = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def peaks(device_name: str) -> dict:
    """The published peaks of the card the run is on."""
    if "H100" not in device_name:
        raise ValueError(f"no published peaks recorded for {device_name!r}")
    return dict(H100_PEAKS)


def attention_forward_flops(shape: Shape, batch: int, seq: int) -> float:
    return float(shape.n_layers) * 2.0 * batch * seq * seq * shape.n_heads * shape.head_dim


def train_step_flops(shape: Shape, batch: int, seq: int) -> float:
    tokens = batch * seq
    return (6.0 * shape.matmul_params(head=True) * tokens
            + 3.0 * attention_forward_flops(shape, batch, seq))


def proxy_head_flops(shape: Shape, tokens: int) -> float:
    return 4.0 * tokens * shape.d_model * shape.vocab_size


def extract_flops(shape: Shape, batch: int, seq: int) -> float:
    """One pool batch of the refresh: forward without the head, then the
    proxy head."""
    return (2.0 * shape.matmul_params(head=False) * batch * seq
            + attention_forward_flops(shape, batch, seq)
            + proxy_head_flops(shape, batch * seq))


def ce_proxy_bound_s(tokens: int, d: int, v: int, elem_bytes: int, peak_flops: float,
                     peak_bytes: float) -> tuple[float, str]:
    """The least time one ``ce_proxy`` launch can take: 4·T·D·V operations
    at the peak, or its bytes (h and W read once in ``elem_bytes``, int32
    labels, the fp32 (T, D) output written once), whichever is larger.
    Returns (seconds, 'ops' or 'bytes')."""
    t_ops = 4.0 * tokens * v * d / peak_flops
    t_bytes = (elem_bytes * (tokens * d + v * d) + 4 * tokens + 4 * tokens * d) / peak_bytes
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
