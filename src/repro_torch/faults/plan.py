"""Deterministic, seedable fault injection.

Port of ``repro.faults.plan``, a copy of the reference's.  A
:class:`FaultPlan` is a declarative list of :class:`FaultSpec` records,
each naming a *hook site* and a *kind* of fault, installed process-wide and
consulted by two hooks threaded through the port's code:

* :func:`fault_point` — a point fault: may raise (:class:`FaultInjected`),
  sleep (``latency``), simulate a missing key (``drop_key``) or kill the
  process (``kill`` — ``SIGKILL``, the real preemption signal);
* :func:`fault_value` — a value fault: transforms the value flowing
  through the site (``nan`` corrupts feature rows).

Hook sites in the port (the reference's names, so one plan arms both
packages):

========================  ====================================================
``refresh.worker``        per-attempt, inside ``AsyncRefresher``'s retry loop
``extract.features``      value hook on ``ProxyExtractor.extract`` output
``service.ingest``        top of ``CoresetService``'s coalesced ingest drain
``kv.get``                every store read of ``distributed.process_tree``
                          (``drop_key`` simulates a missing key)
``tree.publish``          before a process-tree node publishes its candidates
                          (``kill`` is the chaos run's preemption)
========================  ====================================================

Determinism: firing is decided by per-site *call counters* (``on_calls`` /
``every``) or a per-spec seeded RNG (``p``) — two identical plans over the
same call sequence fire identically, and a plan serializes to/from JSON
(the reference's format) so a parent process can arm a *subprocess* via
the ``REPRO_FAULT_PLAN`` environment variable.

No plan installed → the hooks are no-ops; the code pays one module-global
load per hook site.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import signal
import threading
import time

import numpy as np
import torch

__all__ = [
    "ENV_VAR",
    "FAULT_KINDS",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "active_plan",
    "clear",
    "fault_point",
    "fault_value",
    "injected",
    "install",
    "install_from_env",
]

ENV_VAR = "REPRO_FAULT_PLAN"

FAULT_KINDS = ("raise", "latency", "drop_key", "nan", "kill")


class FaultInjected(RuntimeError):
    """An injected fault fired (kind='raise' or a matched 'drop_key')."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault.

    Attributes:
      site: hook-site name this spec instruments (see module docstring).
      kind: one of :data:`FAULT_KINDS`.
      on_calls: 1-based call numbers at the site that fire (deterministic
        Nth-call faults).  ``None`` (with ``every``/``p`` also None) means
        *every* call fires.
      every: fire on calls 1, 1+every, 1+2·every, … (transient-failure
        patterns: ``every=2`` with one retry makes every job fail once and
        then succeed).
      p: per-call firing probability, drawn from the plan's seeded per-spec
        RNG — reproducible chaos.
      latency_s: sleep duration for kind='latency'.
      key_pattern: kind='drop_key' only fires when this substring occurs in
        the hook's ``key`` context (empty = every key).
      rows: kind='nan' corrupts the first ``rows`` rows of the value.
      message: carried in the raised ``FaultInjected``.
    """

    site: str
    kind: str
    on_calls: tuple[int, ...] | None = None
    every: int | None = None
    p: float | None = None
    latency_s: float = 0.0
    key_pattern: str = ""
    rows: int = 1
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}"
            )
        if self.on_calls is not None:
            object.__setattr__(
                self, "on_calls", tuple(int(c) for c in self.on_calls)
            )
            if any(c < 1 for c in self.on_calls):
                raise ValueError("on_calls are 1-based call numbers (≥ 1)")
        if self.every is not None and int(self.every) < 1:
            raise ValueError(f"every={self.every} must be ≥ 1")
        if self.p is not None and not 0.0 <= float(self.p) <= 1.0:
            raise ValueError(f"p={self.p} must be in [0, 1]")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["on_calls"] = None if self.on_calls is None else list(self.on_calls)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        d = dict(d)
        oc = d.get("on_calls")
        if oc is not None:
            d["on_calls"] = tuple(int(c) for c in oc)
        return cls(**d)


class FaultPlan:
    """A set of :class:`FaultSpec` with deterministic firing state.

    Thread-safe: per-site call counters and the per-spec probability RNGs
    are advanced under one lock, so concurrent hook sites (refresh worker
    vs. caller thread) count deterministically per site.
    """

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...], seed: int = 0):
        self.specs = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s)
            for s in specs
        )
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        # one independent RNG stream per spec: adding a spec never perturbs
        # another spec's draw sequence
        self._rngs = [
            random.Random(self.seed * 1_000_003 + i)
            for i in range(len(self.specs))
        ]

    # -- firing ------------------------------------------------------------

    def calls(self, site: str) -> int:
        """Calls observed at ``site`` so far."""
        with self._lock:
            return self._calls.get(site, 0)

    def _fires(self, i: int, spec: FaultSpec, n_call: int, ctx: dict) -> bool:
        if spec.kind == "drop_key" and spec.key_pattern:
            if spec.key_pattern not in str(ctx.get("key", "")):
                return False
        if spec.on_calls is not None:
            return n_call in spec.on_calls
        if spec.every is not None:
            return (n_call - 1) % int(spec.every) == 0
        if spec.p is not None:
            return self._rngs[i].random() < float(spec.p)
        return True

    def apply(self, site: str, value=None, **ctx):
        """Advance the site counter and apply every matching spec.

        Point kinds (raise/latency/drop_key/kill) take effect as side
        effects; 'nan' transforms and returns ``value``.
        """
        with self._lock:
            n_call = self._calls.get(site, 0) + 1
            self._calls[site] = n_call
            firing = [
                spec
                for i, spec in enumerate(self.specs)
                if spec.site == site and self._fires(i, spec, n_call, ctx)
            ]
        for spec in firing:
            if spec.kind == "latency":
                time.sleep(spec.latency_s)
            elif spec.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif spec.kind in ("raise", "drop_key"):
                raise FaultInjected(
                    f"{site} (call {n_call}): {spec.message}"
                    + (f" [key={ctx['key']!r}]" if "key" in ctx else "")
                )
            elif spec.kind == "nan":
                value = _nan_rows(value, spec.rows)
        return value

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {"seed": self.seed, "specs": [s.to_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            [FaultSpec.from_dict(s) for s in d.get("specs", ())],
            seed=int(d.get("seed", 0)),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))


def _nan_rows(value, rows: int):
    """Corrupt the first ``rows`` rows of an array value with NaN.

    A ``torch.Tensor`` in gives a new tensor out, on the same device and
    dtype; anything else goes through numpy (numpy in → float32 numpy
    out).  The value given is never written into.
    """
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        out = value.clone()
        out[: int(rows)] = float("nan")
        return out
    arr = np.array(value, dtype=np.float32, copy=True)
    arr[: int(rows)] = np.nan
    return arr


# ---------------------------------------------------------------------------
# Process-wide installation + hooks
# ---------------------------------------------------------------------------

_ACTIVE: FaultPlan | None = None
_INSTALL_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide (replacing any previous plan)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = plan
    return plan


def clear() -> None:
    """Remove the installed plan (hooks become no-ops again)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None


def active_plan() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Scoped installation: ``with injected(plan): ...`` (tests)."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        if prev is None:
            clear()
        else:
            install(prev)


def install_from_env() -> FaultPlan | None:
    """Install the plan serialized in ``$REPRO_FAULT_PLAN``, if any.

    Subprocess arming: launch entry points (``launch/serve.py``) call
    this before doing real work, so a parent can inject faults into one
    specific child by setting the variable in that child's environment.
    """
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    return install(FaultPlan.from_json(raw))


def fault_point(site: str, **ctx) -> None:
    """Point-fault hook: no-op unless an installed spec matches ``site``."""
    plan = _ACTIVE
    if plan is not None:
        plan.apply(site, **ctx)


def fault_value(site: str, value, **ctx):
    """Value-fault hook: returns ``value`` (possibly transformed)."""
    plan = _ACTIVE
    if plan is None:
        return value
    return plan.apply(site, value, **ctx)
