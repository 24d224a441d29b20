"""Hand-written CUDA kernels for the CRAIG hot spots, with plain-torch twins.

Port of ``repro.kernels``.  Sources live in ``csrc/`` and build at first
use (``_build``); importing this package compiles nothing.  Call the
kernels through ``ops``; ``fl_gains``, ``ce_proxy``, ``topk_sim`` and
``pairwise_l2`` are the modules of launch wrappers and plain twins.
"""
from repro_torch.kernels import ce_proxy, fl_gains, ops, pairwise_l2, ref, topk_sim
from repro_torch.kernels.ops import LAUNCHES

__all__ = ["ce_proxy", "fl_gains", "ops", "pairwise_l2", "ref", "topk_sim", "LAUNCHES"]
