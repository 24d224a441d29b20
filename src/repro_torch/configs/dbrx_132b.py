"""dbrx-132b — MoE, 16 experts top-4 (fine-grained)
(port of ``repro.configs.dbrx_132b``).

[hf:databricks/dbrx-base; unverified] 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 per expert, vocab=100352, 16 experts top-4.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    n_experts=16,
    top_k=4,
    capacity_factor=1.0,
    activation="silu",
    blockwise_threshold=2048,
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
)
