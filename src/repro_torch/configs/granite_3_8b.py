"""granite-3-8b — dense GQA transformer (port of ``repro.configs.granite_3_8b``).

[hf:ibm-granite/granite-3.0-8b-base; hf] 40L d_model=4096 32H (GQA kv=8)
d_ff=12800 vocab=49155, SwiGLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12_800,
    vocab_size=49_155,
    activation="silu",
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-8b-base",
)
