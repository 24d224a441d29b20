"""PyTorch/CUDA port of the CRAIG package ``repro``.

Module paths mirror ``src/repro/`` so each port module sits beside its
reference; the greedy-sweep kernels are hand-written CUDA for Hopper
(``kernels/csrc/``), built at first use.  The port imports neither JAX nor
``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
