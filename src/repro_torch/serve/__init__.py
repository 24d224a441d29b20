"""Serving: the coreset service (streaming selection behind a versioned
delta API).  Port of ``repro.serve``; prefill/decode (``serve_step``) is
not ported yet (ROADMAP.md queue 1, 'Prefill and decode')."""
from repro_torch.serve.coreset_service import CoresetService, CoresetUpdate

__all__ = ["CoresetService", "CoresetUpdate"]
