"""qwen2-7b — dense GQA with QKV bias (port of ``repro.configs.qwen2_7b``).

[arXiv:2407.10671; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, SwiGLU, QKV bias, rope theta 1e6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    activation="silu",
    rope_theta=1e6,
    source="arXiv:2407.10671 / Qwen/Qwen2-7B",
)
