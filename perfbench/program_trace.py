"""Reading the program's own spans (``repro_torch.spans``) from a trace.

A trace recorded with the program's spans on (``spans.enable(True)`` under
a ``torch.profiler`` profile with ``profile_all_threads``) holds a
``repro_torch.*`` user annotation for every span on every thread, and each
one is mirrored on the device's timeline.  ``summarize`` reads such a
trace over its ``bench.window`` span:

* ``base``: ``trace.summarize`` over the same events with the program's
  mirrors left out, as it leaves out the ``bench.*`` ones, so its busy
  seconds, kernels and gaps mean what they mean in a trace without the
  program's spans;
* ``spans``: every program span of the window, from every thread;
* each device activity is attributed to the innermost program span open
  on the thread that launched it, when it was launched.  The kernel is
  joined to its launching CPU operation through kineto's correlation ids
  (the kernel's linked correlation id is the operation's correlation id).
  A backward operation that autograd runs on its own device thread has
  no span open there; it is attributed through the forward thread of
  that thread's latest backward function, where ``step.backward`` is
  open;
* ``gaps``: ``base``'s idle gaps, each label followed by
  ``/<program span>`` when a program span is open on the training thread
  (the one that opened ``bench.window``) at the gap's middle.
"""
from __future__ import annotations

import bisect
import dataclasses
import statistics
from types import SimpleNamespace

from perfbench import trace as tr

__all__ = ["PREFIX", "Span", "SpanTrace", "summarize", "readings"]

PREFIX = "repro_torch."  # repro_torch.spans.PREFIX, which a parent commit may lack
_MIRRORED = (tr.SPAN_PREFIX, PREFIX)  # annotations whose device mirrors are no work
_OPS = ("cpu_op", "user_annotation")  # the CPU events correlation ids name


@dataclasses.dataclass
class Span:
    name: str  # without the prefix
    thread: int
    start: int  # ns on the profiler's clock
    end: int
    parent: int  # index of the enclosing span on its thread, -1 at the top


@dataclasses.dataclass
class SpanTrace:
    base: tr.TraceSummary
    window: tuple  # (start, end) ns
    main: int  # the training thread
    spans: list  # [Span] overlapping the window
    device_s: list  # per span: seconds of device work it was innermost for
    unattributed: dict  # kernel name -> [seconds, count]
    busy: list  # merged device-busy intervals of the window, ns
    gaps: list  # [(label, seconds)] base.gaps relabelled

    def inside(self, name: str) -> list[int]:
        """Indices of the ``name`` spans lying wholly inside the window."""
        a, b = self.window
        return [i for i, s in enumerate(self.spans)
                if s.name == name and s.start >= a and s.end <= b]

    def inclusive_s(self) -> list[float]:
        """Per span: device seconds of it and every span nested in it."""
        depth = [0] * len(self.spans)
        for i, s in enumerate(self.spans):  # a parent is listed before its children
            depth[i] = depth[s.parent] + 1 if s.parent >= 0 else 0
        out = list(self.device_s)
        for i in sorted(range(len(self.spans)), key=lambda i: -depth[i]):
            p = self.spans[i].parent
            if p >= 0:
                out[p] += out[i]
        return out

    def idle_s(self, i: int) -> float:
        """Seconds inside span ``i`` with no device activity."""
        s = self.spans[i]
        a, b = max(s.start, self.window[0]), min(s.end, self.window[1])
        busy = 0
        for x, y in self.busy[max(0, bisect.bisect_right(self.busy, (a,)) - 1):]:
            if x >= b:
                break
            busy += max(0, min(y, b) - max(x, a))
        return (b - a - busy) / 1e9


class _Timeline:
    """The innermost program span open on one thread, by time; spans of
    one thread nest (they are ``with`` blocks)."""

    def __init__(self, items: list):  # [(start, end, index)]
        self.pts: list = []
        self.labs: list = []
        self.parent: dict = {}
        stack: list = []  # [(end, index)]
        for s, e, i in sorted(items, key=lambda x: (x[0], -x[1])):
            self._close(stack, s)
            self.parent[i] = stack[-1][1] if stack else -1
            stack.append((e, i))
            self.pts.append(s)
            self.labs.append(i)
        self._close(stack, None)

    def _close(self, stack: list, before) -> None:
        """Pops the spans that end at or before ``before`` (all: None)."""
        while stack and (before is None or stack[-1][0] <= before):
            end, _ = stack.pop()
            self.pts.append(end)
            self.labs.append(stack[-1][1] if stack else -1)

    def at(self, t: int) -> int:
        k = bisect.bisect_right(self.pts, t) - 1
        return self.labs[k] if k >= 0 else -1


def _is_op(ev) -> bool:
    """A CPU event of the profiler's own (an operation or an annotation),
    not a CUDA API call, whose correlation ids count apart.  Without
    ``activity_type`` (torch before 2.13): an operation links to nothing,
    and the CUDA API calls are named ``cuda*`` and ``cu*``."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in _OPS
    name = ev.name()
    return ev.linked_correlation_id() == 0 and not (
        name.startswith("cuda") or (name[:2] == "cu" and name[2:3].isupper()))


def _merged(intervals: list) -> list:
    """Sorted intervals merged where they touch or overlap."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _gaps(busy: list, t0: int, t1: int, top: int) -> list:
    """The idle gaps of the window between busy intervals, in the order
    ``trace.summarize`` lists them (longest first, ``top`` of them)."""
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return sorted(gaps, key=lambda g: g[0] - g[1])[:top]


def summarize(prof, top: int = 10) -> SpanTrace:
    """Reads the stopped profiler ``prof`` over its ``bench.window`` span."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    kept = [ev for ev in events
            if not (ev.device_type() == DeviceType.CUDA and ev.name().startswith(PREFIX))]
    base = tr.summarize(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: kept))), top)

    window, raw, dev, bwd, links = None, [], [], {}, set()
    for ev in kept:
        name = ev.name()
        start = tr._ns(ev, "start")
        end = start + tr._ns(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(_MIRRORED):
                dev.append((start, end, name, ev.linked_correlation_id()))
                links.add(ev.linked_correlation_id())
            continue
        thread = ev.start_thread_id()
        if name == tr.SPAN_PREFIX + "window":
            window = (start, end, thread)
        elif name.startswith(PREFIX):
            raw.append((start, end, name[len(PREFIX):], thread))
        fwd = ev.fwd_thread_id()
        if fwd and fwd != thread:  # a backward function on autograd's thread
            bwd.setdefault(thread, []).append((start, end, fwd))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    t0, t1, main = window
    launch = {}  # correlation id -> (thread, start) of the launching operation
    for ev in kept:
        if ev.device_type() != DeviceType.CUDA and _is_op(ev):
            c = ev.correlation_id()
            if c and c in links:
                launch[c] = (ev.start_thread_id(), tr._ns(ev, "start"))

    raw = sorted(r for r in raw if r[1] > t0 and r[0] < t1)
    spans = [Span(n, th, a, b, -1) for a, b, n, th in raw]
    lines = {}
    for th in {s.thread for s in spans}:
        line = _Timeline([(s.start, s.end, i) for i, s in enumerate(spans) if s.thread == th])
        for i, p in line.parent.items():
            spans[i].parent = p
        lines[th] = line
    for v in bwd.values():
        v.sort()

    def owner(thread: int, t: int) -> int:
        i = lines[thread].at(t) if thread in lines else -1
        if i < 0 and thread in bwd:
            # autograd's thread works for the forward thread of its latest
            # backward function (its gradient sums run outside any)
            fns = bwd[thread]
            k = max(0, bisect.bisect_right(fns, (t, float("inf"))) - 1)
            if fns[k][2] in lines:
                i = lines[fns[k][2]].at(t)
        return i

    device_s = [0.0] * len(spans)
    unattributed: dict = {}
    clipped = []
    for a, b, name, link in dev:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        clipped.append((a, b))
        i = owner(*launch[link]) if link in launch else -1
        if i >= 0:
            device_s[i] += (b - a) / 1e9
        else:
            k = unattributed.setdefault(name[:160], [0.0, 0])
            k[0] += (b - a) / 1e9
            k[1] += 1
    busy = _merged(clipped)
    gaps = []
    main_line = lines.get(main)
    for (label, secs), (a, b) in zip(base.gaps, _gaps(busy, t0, t1, top)):
        i = main_line.at((a + b) // 2) if main_line else -1
        gaps.append((label if i < 0 else f"{label}/{spans[i].name}", secs))
    return SpanTrace(base, (t0, t1), main, spans, device_s, unattributed, busy, gaps)


def readings(st: SpanTrace) -> dict:
    """The per-layer numbers the program's spans give over the window:
    ``data_ms`` (median host time of ``step.data``), ``step_idle_ms``
    (median device-idle time inside a ``step``), the device time of the
    kernels launched under ``step.forward``, ``step.backward`` and
    ``step.optimizer`` a step (ms), and under ``extract`` a refresh (s),
    beside the share of the window's device time the spans account for.
    A number with nothing to read is left out."""
    out: dict = {}
    steps = st.inside("step")
    data = [st.spans[i] for i in st.inside("step.data")]
    if data:
        out["data_ms"] = statistics.median((s.end - s.start) / 1e6 for s in data)
    if steps:
        out["step_idle_ms"] = 1000.0 * statistics.median(st.idle_s(i) for i in steps)
    incl = st.inclusive_s()
    a, b = st.window
    for name, key in (("step.forward", "forward_device_ms"),
                      ("step.backward", "backward_device_ms"),
                      ("step.optimizer", "optimizer_device_ms")):
        total = sum(incl[i] for i, s in enumerate(st.spans)
                    if s.name == name and s.start >= a and s.end <= b)
        if steps and total > 0:
            out[key] = 1000.0 * total / len(steps)
    ext = [incl[i] for i in st.inside("extract")]
    if ext and sum(ext) > 0:
        out["extract_device_s"] = statistics.mean(ext)
    work = sum(st.device_s) + sum(v[0] for v in st.unattributed.values())
    if work > 0:
        out["attributed_share"] = sum(st.device_s) / work
    return out
