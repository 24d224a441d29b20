"""Synthetic data (port of ``repro.data``; the LM token stream and the
pipeline come with slice 2)."""
from repro_torch.data.synthetic import make_classification

__all__ = ["make_classification"]
