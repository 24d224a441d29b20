"""Synthetic data and the coreset-aware pipeline (port of ``repro.data``)."""
from repro_torch.data.pipeline import CoresetSampler, GlobalBatcher, Prefetcher, to_device
from repro_torch.data.synthetic import GaussianMixture, TokenStream, make_classification

__all__ = [
    "make_classification",
    "GaussianMixture",
    "TokenStream",
    "CoresetSampler",
    "GlobalBatcher",
    "Prefetcher",
    "to_device",
]
