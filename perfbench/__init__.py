"""The port's benchmark: one command runs one cell of ``BENCHMARK.json`` once.

Everything that measures lives here and is frozen against later changes
to the program: the token generator, the seeded weights, the FLOP and
byte counts, the published peaks, the plain reference and the comparison
that decides ``correct``.  Configurations, traffic mixes, metric readers
and limits are files found by name (``spec.py``).  Nothing here imports
``jax`` or the JAX package ``repro``; the reference imports nothing of
``repro_torch``.
"""
