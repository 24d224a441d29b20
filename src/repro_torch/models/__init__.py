"""Decoder-only LM (port of ``repro.models``; dense, MoE, Griffin hybrid and
xLSTM stacks, the token and embeddings frontends, one or several output
heads; training, proxies, prefill and decode)."""
from repro_torch.models.config import ModelConfig, validate_config
from repro_torch.models.model import (
    COMPUTE_DTYPE,
    decode_step,
    forward,
    init_params,
    init_serve_state,
    loss_fn,
    param_shapes,
    prefill,
    proxy_features,
    proxy_features_fused,
    unembed_matrix,
)

__all__ = [
    "ModelConfig",
    "validate_config",
    "COMPUTE_DTYPE",
    "init_params",
    "param_shapes",
    "forward",
    "loss_fn",
    "proxy_features",
    "proxy_features_fused",
    "unembed_matrix",
    "init_serve_state",
    "prefill",
    "decode_step",
]
