"""Published model configurations (port of ``repro.configs``)."""
from repro_torch.configs.registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "get_config", "smoke_config"]
