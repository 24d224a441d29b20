"""CRAIG selection: proxies, engines and the selector (port of ``repro.core``)."""
from repro_torch.core.craig import CoresetSelection, CraigConfig, CraigSelector

__all__ = ["CraigConfig", "CraigSelector", "CoresetSelection"]
