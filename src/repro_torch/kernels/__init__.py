"""Hand-written CUDA kernels for the CRAIG hot spots, with plain-torch twins.

Port of ``repro.kernels``.  Sources live in ``csrc/`` and build at first
use (``_build``); importing this package compiles nothing.  Call the
kernels through ``ops``; ``fl_gains`` and ``ce_proxy`` are the modules of
launch wrappers and plain twins.
"""
from repro_torch.kernels import ce_proxy, fl_gains, ops, ref
from repro_torch.kernels.ops import LAUNCHES

__all__ = ["ce_proxy", "fl_gains", "ops", "ref", "LAUNCHES"]
