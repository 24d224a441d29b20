"""Failure policy for supervised background work.

Port of ``repro.faults.policy`` (``FailurePolicy``), a copy of the
reference's.

One :class:`FailurePolicy` record answers the three questions every
supervised job runner needs answered up front: *how many times to retry*,
*how long to back off between attempts*, and *what to do when retries are
exhausted*.  ``AsyncRefresher`` interprets it per job on the worker
thread; the trainer threads it through its config
(``TrainerConfig.refresh_failure_policy``).

Exhaustion modes:

* ``'raise'`` (default) — the failure is published and re-raised on the
  caller thread at the next ``wait()``/``collect()``/``submit()`` touch
  point; the legacy fail-fast contract.
* ``'keep_stale'`` — the job is abandoned: nothing publishes, the caller
  keeps using the previously installed result (CRAIG keeps sampling the
  stale coreset — still a valid (1−1/e) selection for slightly drifted
  proxies, the CREST observation), and an ``on_failure`` callback fires so
  the abandonment is *logged*, never silent.
* ``'sync_fallback'`` — the failed job re-runs once *inline* on the caller
  thread at the next ``wait()``/``submit()`` — degrade to synchronous
  refresh rather than skipping it; a second failure raises.
"""
from __future__ import annotations

import dataclasses

__all__ = ["EXHAUSTION_MODES", "FailurePolicy"]

EXHAUSTION_MODES = ("raise", "keep_stale", "sync_fallback")


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """Retry/backoff/exhaustion knobs for one supervised job family.

    Attributes:
      max_retries: extra attempts after the first failure (0 = fail fast).
      backoff_base_s: sleep before retry k is ``base · 2^k``, capped.
      backoff_cap_s: upper bound on any single backoff sleep.
      on_exhaustion: what happens when every attempt failed (module
        docstring).
    """

    max_retries: int = 0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    on_exhaustion: str = "raise"

    def __post_init__(self):
        if int(self.max_retries) < 0:
            raise ValueError(f"max_retries={self.max_retries} must be ≥ 0")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff durations must be ≥ 0")
        if self.on_exhaustion not in EXHAUSTION_MODES:
            raise ValueError(
                f"on_exhaustion={self.on_exhaustion!r} is not a mode; "
                f"expected one of {EXHAUSTION_MODES}"
            )

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retrying after (0-based) failed attempt ``attempt``."""
        return min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FailurePolicy":
        return cls(**d)
