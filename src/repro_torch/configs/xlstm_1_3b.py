"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM)
(port of ``repro.configs.xlstm_1_3b``).

[arXiv:2405.04517; unverified] 48L d_model=2048 4H d_ff=0 (projections live
inside the xLSTM cells) vocab=50304.  48 = 6 full (7×mlstm, 1×slstm)
periods.  Fully recurrent → long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    d_head=512,  # inner dim = n_heads·d_head = d_model
    mlstm_chunk=256,
    source="arXiv:2405.04517 (xLSTM)",
)
