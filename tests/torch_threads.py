"""One intra-op thread for the port's CPU tests.

The suite runs under ``pytest -n 6`` (six worker processes).  Each
worker's PyTorch would start one OpenMP thread a core, so six workers keep
about six times as many busy threads as an 8-core host has cores, and the
port's small smoke-width ops spend their time waiting on each other: six
of the slowest port test files took 323 s of wall time under ``-n 6
--dist loadfile`` with eight threads a worker and 106 s with one (same
command and host, one run each).  Every ``tests/test_torch_*.py`` imports
this module, so a worker that collects any of them runs its torch ops on
one thread; results do not depend on it beyond the summation order of
CPU reductions, which every parity tolerance already covers.
"""
import torch

torch.set_num_threads(1)
