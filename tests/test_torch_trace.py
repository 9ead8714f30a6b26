"""The port's spans (``repro_torch.trace``) and the batcher's
``waiting_at_launch`` counter, on the CPU.

* ``span`` is one shared no-op while no profiler runs.
* Under ``torch.profiler`` (every thread recorded) a 2-lane fleet records
  the driver's, the prefetcher's, the prelude's and the scheduler's spans,
  nested as the layers call each other, with ``agocs.sched.external``
  only when a lane draws random preferences; a served query records the
  service's spans on the batcher's thread.
* The stats frames are bitwise the same with and without the profiler.
* ``waiting_at_launch`` over a stub executor, counted by hand.
"""
import collections
import os
import tempfile
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.config import REDUCED_SIM
from repro_torch.core.precompile import precompile_trace, replay_config
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.scenarios import ScenarioFleet, ScenarioSpec
from repro_torch.service import MicroBatcher, WhatIfQuery, WhatIfServer

BW = 8
N_STACK = 32

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stack():
    with tempfile.TemporaryDirectory() as d:
        generate_trace(d, n_machines=16, n_jobs=40, horizon_windows=N_STACK,
                       seed=5, usage_period_us=10_000_000)
        path = os.path.join(d, "stack.npz")
        precompile_trace(REDUCED_SIM, d, path, N_STACK,
                         start_us=SHIFT_US - REDUCED_SIM.window_us,
                         shard_windows=BW)
        yield path


@pytest.fixture(scope="module")
def cfg(stack):
    return replay_config(stack, REDUCED_SIM)


def _profiled(fn):
    """``fn()``'s result and the program spans of every thread it ran:
    {thread: [(start, end, name)]} sorted by start, longest first."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        out = fn()
    spans = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("agocs."):
            spans[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(), e.name()))
    for v in spans.values():
        v.sort(key=lambda x: (x[0], -x[1]))
    return out, dict(spans)


def _parents(spans):
    """{name: set of the names of its innermost enclosing span (None at
    the top)} over one thread's nested spans."""
    out = collections.defaultdict(set)
    stack = []
    for s, e, name in spans:
        while stack and stack[-1][1] < s:
            stack.pop()
        out[name].add(stack[-1][2] if stack else None)
        stack.append((s, e, name))
    return dict(out)


def _fleet(cfg, stack, schedulers):
    specs = [ScenarioSpec(name=f"lane{i}", scheduler=s)
             for i, s in enumerate(schedulers)]
    fleet = ScenarioFleet.from_precompiled(cfg, stack, specs,
                                           batch_windows=BW, device="cpu")
    fleet.run()
    return fleet.stats_frame()


def test_span_is_a_shared_noop_without_a_profiler():
    a, b = trace.span("agocs.a"), trace.span("agocs.b")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("agocs.a") is not a


@pytest.mark.parametrize("schedulers", [("greedy", "random"),
                                        ("greedy", "first_fit")])
def test_fleet_records_its_spans_nested(cfg, stack, schedulers):
    frame, spans = _profiled(lambda: _fleet(cfg, stack, schedulers))
    main = spans[max(spans, key=lambda t: len(spans[t]))]
    parents = _parents(main)
    advance = {"agocs.driver.advance"}
    want = {"agocs.driver.next_batch": {None},
            "agocs.driver.advance": {None},
            "agocs.fleet.perturb": advance, "agocs.fleet.events": advance,
            "agocs.fleet.stats": advance, "agocs.sched.base": advance,
            "agocs.sched.commit": advance}
    if cfg.incremental_accounting and cfg.resync_windows < N_STACK:
        want["agocs.driver.resync"] = {None}
    if "random" in schedulers:
        want["agocs.sched.external"] = advance
    assert parents == want
    # the metric spans are leaves: no program span inside them
    for leaf in ("agocs.sched.external", "agocs.fleet.perturb"):
        assert leaf not in set().union(*parents.values())
    windows = frame["n_running"].shape[0]
    count = collections.Counter(n for _, _, n in main)
    assert count["agocs.fleet.perturb"] == 2 * windows
    assert count["agocs.driver.advance"] == N_STACK // BW
    # the pre-stacked batches are staged on the fill thread, pageable
    fill = [n for t, v in spans.items() if v is not main for _, _, n in v]
    assert set(fill) == {"agocs.prefetch.stage_pageable"}
    assert len(fill) == N_STACK // BW


def test_frames_are_the_same_with_and_without_the_profiler(cfg, stack):
    plain = _fleet(cfg, stack, ("greedy", "random"))
    traced, _ = _profiled(lambda: _fleet(cfg, stack, ("greedy", "random")))
    assert plain.keys() == traced.keys()
    for k in plain:
        assert np.array_equal(plain[k], traced[k]), k


def test_served_query_records_the_service_spans(cfg, stack):
    srv = WhatIfServer(cfg, stack, schedulers=("greedy", "random"),
                       max_lanes=2, max_wait_s=0.01, batch_windows=BW,
                       device="cpu")
    srv.start(warm=True)
    try:
        q = WhatIfQuery(spec=ScenarioSpec(name="q", scheduler="random"),
                        n_windows=2 * BW)
        res, spans = _profiled(lambda: srv.query(q, timeout=120))
    finally:
        srv.stop()
    assert res.ok()
    batcher = [v for v in spans.values()
               if any(n == "agocs.service.batch" for _, _, n in v)]
    assert len(batcher) == 1
    parents = _parents(batcher[0])
    batch = {"agocs.service.batch"}
    assert parents["agocs.service.wait"] == {None}
    assert parents["agocs.service.batch"] == {None}
    for name in ("agocs.service.start_state", "agocs.service.chunk",
                 "agocs.service.collect", "agocs.service.report",
                 "agocs.fleet.perturb", "agocs.sched.external"):
        assert parents[name] == batch, name
    count = collections.Counter(n for _, _, n in batcher[0])
    assert count["agocs.service.batch"] == 1
    assert count["agocs.service.chunk"] == 2


def test_waiting_at_launch_counts_the_tickets_left_behind():
    entered, release = threading.Event(), threading.Event()
    calls = []

    def execute(tickets):
        calls.append([t.query.spec.name for t in tickets])
        if len(calls) == 1:
            entered.set()
            assert release.wait(30)
        for t in tickets:
            t.fail("TEST", "stub")

    def q(name, n=1):
        return WhatIfQuery(spec=ScenarioSpec(name=name), n_windows=n)

    mb = MicroBatcher(execute, max_lanes=2, max_wait_s=60.0)
    mb.start()
    tickets = [mb.submit(q("a")), mb.submit(q("b"))]
    assert entered.wait(30)                 # a and b: nothing else waits
    # while a, b run: c, d, e queue for one bucket, f for another
    tickets += [mb.submit(q(x)) for x in "cde"] + [mb.submit(q("f", 2))]
    release.set()
    # c, d fill a bucket and leave e, f queued (2); at the stop the
    # drain launches e with f bucketed (1), then f alone (0)
    mb.stop(drain=True)
    assert calls == [["a", "b"], ["c", "d"], ["e"], ["f"]]
    assert all(t.done.is_set() for t in tickets)
    assert mb.metrics.snapshot()["waiting_at_launch"] == 0 + 2 + 1 + 0
