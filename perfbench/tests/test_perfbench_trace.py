"""``program_trace.summarize`` on synthetic event lists shaped as kineto's:
the program's annotations mirrored on the device are no device work, a
kernel belongs to the innermost program span open on the thread that
launched it, gaps name the program span open on the training thread, and
a trace without program spans reads exactly as ``trace.summarize`` reads
it."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import program_trace as pt
from perfbench import trace as tr

MAIN, WORKER, AUTOGRAD = 1, 2, 3


class OldEv:
    """The methods of a kineto event the readers call (torch before 2.13)."""

    def __init__(self, name, a, b, thread=MAIN, cuda=False, corr=0, link=0, fwd=0,
                 kind=None):
        self._v = (name, a, b, thread, cuda, corr, link, fwd)
        self._kind = kind or ("kernel" if cuda else "user_annotation" if "." in name
                              else "cpu_op")

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        return DeviceType.CUDA if self._v[4] else DeviceType.CPU

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def fwd_thread_id(self):
        return self._v[7]


class Ev(OldEv):
    def activity_type(self):
        return self._kind


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def _span(name, a, b, thread=MAIN):
    return Ev(pt.PREFIX + name, a, b, thread)


def _mirror(name, a, b):  # a program span on the device's timeline
    return Ev(pt.PREFIX + name, a, b, thread=0, cuda=True, kind="gpu_user_annotation")


# A 1,000-ns window.  Training thread: a step with its data, backward and
# optimizer spans; an add launched under step.optimizer; a backward on
# autograd's thread for step.backward, and a gradient sum there after it.
# Worker thread: a refresh whose extract launches a product.  Device: four
# kernels, busy [200, 300], [450, 520], [600, 700], and the mirrors.
BASE = [
    Ev("bench.window", 0, 1000),
    Ev("bench.train_step", 300, 900),
    Ev("aten::add", 550, 560, corr=11),
    Ev("aten::mm", 130, 140, WORKER, corr=12),
    Ev("MmBackward0", 400, 450, AUTOGRAD, fwd=MAIN),
    Ev("aten::mm", 410, 420, AUTOGRAD, corr=13),
    Ev("aten::add", 455, 458, AUTOGRAD, corr=14),  # a gradient sum outside MmBackward0
    # a runtime call whose correlation id (CUPTI's) equals the worker's mm's
    Ev("cudaLaunchKernel", 556, 559, corr=12, link=11, kind="cuda_runtime"),
    Ev("add_kernel", 600, 700, cuda=True, corr=901, link=11),
    Ev("gemm_kernel", 200, 300, cuda=True, corr=902, link=12),
    Ev("gemm_bwd_kernel", 450, 500, cuda=True, corr=903, link=13),
    Ev("add_kernel", 500, 520, cuda=True, corr=904, link=14),
]
SPANS = [
    _span("step", 0, 950), _span("step.data", 20, 190), _span("step.backward", 380, 480),
    _span("step.optimizer", 500, 800), _span("refresh", 100, 960, WORKER),
    _span("extract", 120, 900, WORKER),
]
MIRRORS = [_mirror("step", 0, 950), _mirror("extract", 120, 900)]


def test_a_trace_without_program_spans_reads_as_today():
    want = tr.summarize(_prof(BASE))
    got = pt.summarize(_prof(BASE))
    assert got.base == want
    assert got.gaps == want.gaps and got.spans == [] and sum(got.device_s) == 0
    assert set(got.unattributed) == set(want.kernels)


def test_program_mirrors_on_the_device_are_no_device_work():
    got = pt.summarize(_prof(BASE + SPANS + MIRRORS))
    assert got.base == tr.summarize(_prof(BASE))
    assert got.base.busy_s == pytest.approx(270e-9)
    assert not any(n.startswith(pt.PREFIX) for n in got.base.kernels)
    # the reader this replaces would count them as work
    assert tr.summarize(_prof(BASE + SPANS + MIRRORS)).busy_s > 900e-9


def _old(events):
    return [OldEv(*e._v, kind=e._kind) for e in events]


@pytest.mark.parametrize("old", [False, True], ids=["activity_type", "without"])
def test_each_kernel_belongs_to_the_span_open_where_it_was_launched(old):
    events = BASE + SPANS + MIRRORS
    got = pt.summarize(_prof(_old(events) if old else events))
    by = {s.name: got.device_s[i] for i, s in enumerate(got.spans)}
    assert by["step.optimizer"] == pytest.approx(100e-9)  # training thread
    assert by["extract"] == pytest.approx(100e-9)  # worker thread
    assert by["step.backward"] == pytest.approx(70e-9)  # autograd's thread
    assert by["step"] == by["refresh"] == by["step.data"] == 0
    assert got.unattributed == {}
    incl = dict(zip((s.name for s in got.spans), got.inclusive_s()))
    assert incl["step"] == pytest.approx(170e-9) and incl["refresh"] == pytest.approx(100e-9)
    assert [got.spans[i].parent for i in got.inside("extract")] == [
        next(i for i, s in enumerate(got.spans) if s.name == "refresh")]


def test_gaps_name_the_program_span_open_on_the_training_thread():
    got = pt.summarize(_prof(BASE + SPANS + MIRRORS))
    labels = dict((round(s * 1e9), n) for n, s in got.gaps)
    # gaps by length, labelled at their middles
    assert labels == {200: "no bench span/step.data",  # at 100
                      150: "train_step/step",  # at 375, before step.backward opens
                      80: "train_step/step.optimizer",  # at 560
                      300: "train_step/step"}  # at 850


def test_readings():
    r = pt.readings(pt.summarize(_prof(BASE + SPANS + MIRRORS)))
    assert r["data_ms"] == pytest.approx(170e-6)
    assert r["optimizer_device_ms"] == pytest.approx(100e-6)
    assert r["backward_device_ms"] == pytest.approx(70e-6)
    assert r["extract_device_s"] == pytest.approx(100e-9)
    assert r["step_idle_ms"] == pytest.approx((950 - 270) * 1e-6)
    assert r["attributed_share"] == pytest.approx(1.0)
    assert "forward_device_ms" not in r
