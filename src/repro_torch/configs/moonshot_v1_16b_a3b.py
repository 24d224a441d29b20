"""moonshot-v1-16b-a3b — fine-grained MoE (Moonlight), 64 experts top-6
(port of ``repro.configs.moonshot_v1_16b_a3b``).

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (MHA kv=16)
d_ff=1408 per expert, vocab=163840, 64 experts top-6 + 2 shared experts
(DeepSeek-V2-style fine-grained + shared).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    capacity_factor=1.25,
    activation="silu",
    source="hf:moonshotai/Moonlight-16B-A3B",
)
