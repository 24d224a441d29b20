"""musicgen-medium — decoder-only LM over EnCodec tokens
(port of ``repro.configs.musicgen_medium``).

[arXiv:2306.05284; hf] 48L d_model=1536 24H (MHA, kv=24) d_ff=6144
vocab=2048 (per codebook), 4 codebooks with parallel heads (delay pattern's
per-stream heads).  The EnCodec frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings (B, T, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    activation="gelu",
    gated_ffn=False,
    norm="layernorm",
    frontend="embeddings",
    n_codebooks=4,
    source="arXiv:2306.05284 / facebook/musicgen-medium",
)
