"""recurrentgemma-9b — Griffin: RG-LRU + local attention, 1:2 pattern (port
of ``repro.configs.recurrentgemma_9b``).

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1, i.e. MQA on
the attention layers) d_ff=12288 vocab=256000, local window 2048.
38 = 12 full (rglru, rglru, local_attn) periods + 2 remainder rglru layers.
Sub-quadratic (no global attention) → long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    d_rnn=4096,
    activation="gelu",  # GeGLU
    gated_ffn=True,
    rope_theta=10_000.0,
    source="arXiv:2402.19427 (Griffin) / google/recurrentgemma-9b",
)
