"""qwen2-vl-7b — Qwen2-7B backbone with M-RoPE; vision frontend stubbed
(port of ``repro.configs.qwen2_vl_7b``).

[arXiv:2409.12191; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; M-RoPE sections (16, 24, 24) over the 64 rotary slots;
dynamic-resolution ViT frontend is a STUB — ``input_specs`` provides
precomputed patch/token embeddings (B, T, d_model) and (B, 3, T) position
ids.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    activation="silu",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    frontend="embeddings",
    source="arXiv:2409.12191 / Qwen/Qwen2-VL-7B",
)
