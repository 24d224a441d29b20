"""Architecture lookup (port of ``repro.configs.registry.get_config``).

Only the configurations the port runs are registered; the reference's
other architectures come with their families (ROADMAP.md queue 1,
slice 5).
"""
from __future__ import annotations

from repro_torch.configs import qwen3_1_7b
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS: dict[str, ModelConfig] = {c.CONFIG.name: c.CONFIG for c in (qwen3_1_7b,)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return ARCHS[arch]
