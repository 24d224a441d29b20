"""Architecture registry: full configs and reduced smoke variants.

Port of ``repro.configs.registry`` (``ARCHS``, ``get_config``,
``smoke_config``): the reference's ten architectures.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    dbrx_132b,
    granite_3_8b,
    moonshot_v1_16b_a3b,
    musicgen_medium,
    nemotron_4_15b,
    qwen2_7b,
    qwen2_vl_7b,
    qwen3_1_7b,
    recurrentgemma_9b,
    xlstm_1_3b,
)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "smoke_config"]

ARCHS: dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (
        recurrentgemma_9b,
        musicgen_medium,
        xlstm_1_3b,
        granite_3_8b,
        qwen2_7b,
        qwen3_1_7b,
        nemotron_4_15b,
        moonshot_v1_16b_a3b,
        dbrx_132b,
        qwen2_vl_7b,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return ARCHS[arch]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: one period + remainder, tiny dims."""
    full = get_config(arch)
    period = len(full.block_pattern)
    n_layers = period + min(2, period)  # ≥1 full period + remainder layers
    d_model = 64
    n_heads = min(full.n_heads, 4)
    # keep the GQA ratio flavor: MQA stays MQA, MHA stays MHA
    if full.n_kv_heads == 1:
        n_kv = 1
    elif full.n_kv_heads == full.n_heads:
        n_kv = n_heads
    else:
        n_kv = max(1, n_heads // 2)
    return dataclasses.replace(
        full,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_model // n_heads if full.d_head else 0,
        d_ff=128 if full.d_ff else 0,
        vocab_size=512,
        n_experts=4 if full.n_experts else 0,
        top_k=2 if full.n_experts else 0,
        n_shared_experts=1 if full.n_shared_experts else 0,
        d_rnn=d_model if full.d_rnn else 0,
        window=8 if full.window else None,
        mrope_sections=(4, 2, 2) if full.mrope_sections else None,
        mlstm_chunk=8,
        blockwise_threshold=64,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        logit_chunk=16,
    )
