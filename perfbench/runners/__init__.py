"""Runners: one module a kind of cell, named by a traffic mix's
``"runner"`` key and found by name (``perfbench.spec``).

A runner has ``MIX_KEYS`` (the mix keys it reads, every one), ``PLANTS``
(the faults it can plant beneath its timed path for the tests and the
calibration) and ``run(cell, seed, seconds, trace, device, t_start,
plant=None, log=print)``, which returns an object with ``run`` (what the
metric readers read; it has ``setup_s``, ``window_s``, ``peak_bytes`` and
``trace``, a ``trace.TraceSummary`` of a traced run or None), ``numbers``
(compared against ``limits/<cell>.json``), ``shown`` (readings printed,
not compared), ``attempted`` and ``failed``.
"""
