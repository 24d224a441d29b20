"""qwen3-1.7b — dense GQA with qk-norm (port of ``repro.configs.qwen3_1_7b``).

[hf:Qwen/Qwen3-1.7B; hf] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, SwiGLU, qk_norm, head_dim=128, rope theta 1e6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    activation="silu",
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-1.7B",
)
