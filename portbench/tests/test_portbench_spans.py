"""The harness's readers of the program's spans (``harness/spans``) on
traces made by hand, the traced window unchanged by the program's host
spans, and a tiny traced sweep on the CPU under every thread's profiler."""
import types

import pytest

from portbench_cells import ROOT, tiny_job
from portbench.harness import common, manifest, spans, sweep
from portbench.harness.profile import Window

MS = 1_000_000


class _Ev:
    """One event of a kineto trace, as ``Window`` and ``spans`` read it."""

    def __init__(self, name, start, end, cuda=False, tid=1, corr=0,
                 linked=0):
        self._v = (name, start, end, cuda, tid, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(events))))


def _trace(with_spans: bool):
    """A 100 ms window on thread 1: a batch wait (0-10 ms, the device idle),
    an advance (10-80 ms) whose draws (20-50 ms) launch kernel k2 and whose
    commit (50-80 ms) launches D; the device idle again from 90 ms. Thread
    2 (a fill thread) copies in 60-70 ms from a pageable stage. Without the
    spans D links to no recorded host op."""
    ev = [_Ev(common.WINDOW_SPAN, 0, 100 * MS),
          _Ev(common.WINDOW_SPAN, 10 * MS, 90 * MS, cuda=True),
          _Ev("aten::add", 11 * MS, 12 * MS, corr=11),
          _Ev("cudaLaunchKernel", 11 * MS, 12 * MS, linked=11),
          _Ev("k1", 10 * MS, 20 * MS, cuda=True, linked=11),
          _Ev("aten::uniform", 21 * MS, 22 * MS, corr=21),
          _Ev("cudaLaunchKernel", 21 * MS, 22 * MS, linked=21),
          _Ev("k2", 20 * MS, 50 * MS, cuda=True, linked=21),
          # D is launched in the commit span itself, under no ATen op
          _Ev("cudaLaunchKernel", 51 * MS, 52 * MS, linked=4),
          _Ev("sched_commit_kernel", 50 * MS, 85 * MS, cuda=True,
              linked=4),
          _Ev("aten::copy_", 61 * MS, 62 * MS, tid=2, corr=61),
          _Ev("cudaMemcpyAsync", 61 * MS, 62 * MS, tid=2, linked=61),
          _Ev("Memcpy HtoD (Pageable)", 60 * MS, 70 * MS, cuda=True,
              linked=61),
          _Ev("k3", 85 * MS, 90 * MS, cuda=True),
          # a runtime event whose CUPTI id is an op's id: not a launcher
          _Ev("cudaStreamSynchronize", 95 * MS, 96 * MS, corr=21)]
    if with_spans:
        ev += [_Ev("agocs.driver.next_batch", 0, 10 * MS, corr=1),
               _Ev("agocs.driver.advance", 10 * MS, 80 * MS, corr=2),
               _Ev("agocs.sched.external", 20 * MS, 50 * MS, corr=3),
               _Ev("agocs.sched.commit", 50 * MS, 80 * MS, corr=4),
               _Ev("agocs.prefetch.stage_pageable", 60 * MS, 65 * MS, tid=2,
                   corr=5),
               _Ev("agocs.driver.next_batch", 88 * MS, 100 * MS, corr=6)]
    return _prof(ev)


def test_program_spans_leave_the_window_unchanged():
    plain = Window(_trace(False), common.WINDOW_SPAN)
    spanned = Window(_trace(True), common.WINDOW_SPAN)
    assert spanned.device_ops == plain.device_ops
    assert len(plain.device_ops) == 5
    assert spanned.busy_s() == plain.busy_s() == pytest.approx(0.080)
    assert spanned.letters() == plain.letters()
    assert spanned.gaps() == plain.gaps() == [(0, 10 * MS), (90 * MS,
                                                             100 * MS)]
    man = manifest.Manifest(ROOT)
    inputs = {"windows": 4, "work": {"A": (1e9, 0.0), "D": (1e9, 0.0)}}
    for name in man.readers("cellA-sweep64.grid"):
        if name == "wait_idle_share.sweep":
            continue
        read = man.reader(name)
        assert read(inputs, spanned) == read(inputs, plain), name


def test_idle_by_program_span_and_wait_idle_share():
    plain = Window(_trace(False), common.WINDOW_SPAN)
    spanned = Window(_trace(True), common.WINDOW_SPAN)
    assert spans.idle_by_program_span(plain) is None
    # both gaps open in a wait for the next batch (the second at 90 ms,
    # in the wait that began at 88)
    assert spans.idle_by_program_span(spanned) == {
        "agocs.driver.next_batch": pytest.approx(0.020)}
    read = manifest.Manifest(ROOT).reader("wait_idle_share.sweep")
    assert read({}, spanned) == pytest.approx(20.0)
    assert read({}, plain) is None
    assert read({}, None) is None


def test_idle_outside_every_span():
    ev = _trace(True).profiler.kineto_results.events()
    ev = [e for e in ev if not (e.name() == "agocs.driver.next_batch"
                                and e.start_ns() == 88 * MS)]
    w = Window(_prof(ev), common.WINDOW_SPAN)
    assert spans.idle_by_program_span(w) == {
        "agocs.driver.next_batch": pytest.approx(0.010),
        spans.OUTSIDE: pytest.approx(0.010)}
    assert spans.wait_idle_share(w) == pytest.approx(10.0)


def test_device_by_span_follows_the_launching_op():
    got = spans.device_by_span(
        _trace(True).profiler.kineto_results.events(), 0, 100 * MS,
        common.WINDOW_SPAN)
    assert got == {
        "agocs.driver.advance": (1, pytest.approx(0.010)),
        "agocs.sched.external": (1, pytest.approx(0.030)),
        "agocs.sched.commit": (1, pytest.approx(0.035)),
        "agocs.prefetch.stage_pageable": (1, pytest.approx(0.010)),
        spans.UNLINKED: (1, pytest.approx(0.005))}
    # without the program's spans every op is outside them
    bare = spans.device_by_span(
        _trace(False).profiler.kineto_results.events(), 0, 100 * MS,
        common.WINDOW_SPAN)
    assert bare == {spans.OUTSIDE: (3, pytest.approx(0.050)),
                    spans.UNLINKED: (2, pytest.approx(0.040))}
    # clipped to the window, as Window.device_ops
    clipped = spans.device_by_span(
        _trace(True).profiler.kineto_results.events(), 30 * MS, 60 * MS,
        common.WINDOW_SPAN)
    assert clipped["agocs.sched.external"] == (1, pytest.approx(0.020))
    assert clipped["agocs.sched.commit"] == (1, pytest.approx(0.010))


def test_span_window_on_a_tiny_traced_sweep(monkeypatch):
    monkeypatch.setattr(common, "window_profile", spans.all_threads_profile)
    job = tiny_job("cellA-sweep64.grid", trace=True)
    out = sweep.run(job)
    assert out.verdict.correct, out.verdict.as_json()
    w = out.window
    assert isinstance(w, spans.SpanWindow)
    # the CPU launches nothing: no device op, no dispatching thread
    assert w.by_span == {} and w.dispatch_thread is None
    assert spans.idle_by_program_span(w) is None
