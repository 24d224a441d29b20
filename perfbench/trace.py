"""Reading a ``torch.profiler`` trace of the measured window.

Device time comes from the CUDA activities (kernels, copies, sets); host
activity from the ``bench.*`` spans the harness records around its calls
into the program.  ``summarize`` returns the window's busy seconds (the
union of device activity), its length, the device time and count of each
kernel name, and the longest idle gaps, each labelled by the innermost
``bench.*`` span open on the training thread at the gap's middle.
"""
from __future__ import annotations

import bisect
import dataclasses

__all__ = ["TraceSummary", "summarize", "SPAN_PREFIX"]

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [seconds, count]
    gaps: list  # [(label, seconds)] longest first

    def time_of(self, part: str) -> tuple[float, int]:
        """Total seconds and launches of kernels whose name holds ``part``."""
        s, n = 0.0, 0
        for name, (t, c) in self.kernels.items():
            if part in name:
                s += t
                n += c
        return s, n


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def summarize(prof, top: int = 10) -> TraceSummary:
    """Summary of the profiler ``prof`` (stopped) over its ``bench.window``
    span; host spans are those of the thread that opened it."""
    from torch.autograd import DeviceType

    dev, spans, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if name.startswith(SPAN_PREFIX):
            # a span mirrored on the device's timeline is no device work
            if ev.device_type() != DeviceType.CUDA:
                if name == SPAN_PREFIX + "window":
                    window = (start, end, ev.start_thread_id())
                else:
                    spans.append((start, end, name[len(SPAN_PREFIX):], ev.start_thread_id()))
        elif ev.device_type() == DeviceType.CUDA:
            dev.append((start, end, name))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    t0_ns, t1_ns, main = window
    spans = [(a, b, n) for a, b, n, t in spans if t == main]
    dev = [(max(a, t0_ns), min(b, t1_ns), n) for a, b, n in dev if b > t0_ns and a < t1_ns]
    dev.sort()
    kernels: dict = {}
    for a, b, n in dev:
        k = kernels.setdefault(n[:160], [0.0, 0])
        k[0] += (b - a) / 1e9
        k[1] += 1
    busy, gaps, cur_a, cur_b = 0, [], None, t0_ns
    for a, b, _ in dev:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            if a > cur_b:
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if t1_ns > cur_b:
        gaps.append((cur_b, t1_ns))
    spans.sort()
    starts = [s[0] for s in spans]
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        label, width = "no bench span", None
        for s, e, n in spans[:bisect.bisect_right(starts, mid)]:
            if s <= mid <= e and (width is None or e - s < width):
                label, width = n, e - s
        labelled.append((label, (b - a) / 1e9))
    return TraceSummary((t1_ns - t0_ns) / 1e9, busy / 1e9, kernels, labelled)
