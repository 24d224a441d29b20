"""nemotron-4-15b — dense GQA with squared-ReLU FFN (no gating) (port of ``repro.configs.nemotron_4_15b``).

[arXiv:2402.16819; unverified] 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    activation="relu2",
    gated_ffn=False,
    rope_theta=10_000.0,
    source="arXiv:2402.16819 (Nemotron-4)",
)
