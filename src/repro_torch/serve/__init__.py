"""Serving (port of ``repro.serve``): the coreset service (streaming
selection behind a versioned delta API) and LM prefill/decode
(``serve_step``)."""
from repro_torch.serve.coreset_service import CoresetService, CoresetUpdate
from repro_torch.serve.serve_step import greedy_generate, make_prefill_step, make_serve_step

__all__ = ["CoresetService", "CoresetUpdate", "make_prefill_step", "make_serve_step",
           "greedy_generate"]
