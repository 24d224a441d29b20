"""Decoder-only LM (port of ``repro.models``; dense and MoE 'attn' layers)."""
from repro_torch.models.config import ModelConfig, require_ported
from repro_torch.models.model import (
    COMPUTE_DTYPE,
    forward,
    init_params,
    loss_fn,
    param_shapes,
    proxy_features,
    proxy_features_fused,
    unembed_matrix,
)

__all__ = [
    "ModelConfig",
    "require_ported",
    "COMPUTE_DTYPE",
    "init_params",
    "param_shapes",
    "forward",
    "loss_fn",
    "proxy_features",
    "proxy_features_fused",
    "unembed_matrix",
]
