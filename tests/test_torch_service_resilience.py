"""The port's what-if service under armed FaultPlans: the micro-batcher's
failure paths (cancellation, deadlines, bounded-queue shedding and the
priority lane, supervised restarts) and the server end to end under
injected launch and restore faults — the batcher and server tests of
``tests/test_resilience.py``, on the CPU. Results served under chaos must
stay bitwise equal to an unfaulted direct fleet run.

The breaker test drives the breaker's clock instead of sleeping, and reads
``breaker_closes`` straight after the probe query returns: the port counts
the breaker's close before it finishes any ticket of the batch."""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.config import REDUCED_SIM
from repro_torch.core.precompile import precompile_trace, replay_config
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.resilience import (BreakerPolicy, FaultPlan, RetryPolicy,
                                    armed, disarm)
from repro_torch.scenarios import ScenarioFleet, ScenarioSpec
from repro_torch.scenarios.report import scenario_report
from repro_torch.service import (ErrorCode, MicroBatcher, ServiceMetrics,
                                 Ticket, WhatIfQuery, WhatIfResult,
                                 WhatIfServer)

BW = 16
N_STACK = 64
CFG = REDUCED_SIM

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _always_disarm():
    """A failing test must never leave its plan armed for the next one."""
    yield
    disarm()


@pytest.fixture(scope="module")
def stack():
    with tempfile.TemporaryDirectory() as d:
        generate_trace(d, n_machines=16, n_jobs=40, horizon_windows=N_STACK,
                       seed=5, usage_period_us=10_000_000)
        path = os.path.join(d, "stack.npz")
        precompile_trace(CFG, d, path, N_STACK,
                         start_us=SHIFT_US - CFG.window_us, shard_windows=BW)
        yield path


@pytest.fixture(scope="module")
def cfg(stack):
    return replay_config(stack, CFG)


# --- batcher failure paths ---------------------------------------------------

def _ok_executor(log):
    def execute(tickets):
        log.append([t.query.spec.name for t in tickets])
        for t in tickets:
            t.finish(WhatIfResult(name=t.query.spec.name, scheduler="greedy",
                                  start_window=0, n_windows=1, row={}))
    return execute


def test_abandoned_ticket_is_cancelled_not_launched():
    log = []
    mb = MicroBatcher(_ok_executor(log), max_lanes=4, max_wait_s=0.15,
                      metrics=ServiceMetrics())
    mb.start()
    try:
        t = mb.submit(WhatIfQuery(ScenarioSpec(name="ghost"), n_windows=1))
        with pytest.raises(TimeoutError, match="cancelled"):
            t.wait(timeout=0.01)               # caller gives up pre-dispatch
        assert t.done.wait(10)                 # batcher still resolves it
        assert t.result.code == ErrorCode.CANCELLED
        assert log == []                       # the lane was never launched
        m = mb.metrics.snapshot()
        assert m["resilience"]["cancelled"] == 1
        assert m["errors_by_code"] == {ErrorCode.CANCELLED: 1}
    finally:
        mb.stop()


def test_expired_deadline_shed_at_dispatch():
    log = []
    mb = MicroBatcher(_ok_executor(log), max_lanes=4, max_wait_s=0.05,
                      metrics=ServiceMetrics())
    mb.start()
    try:
        t = mb.submit(WhatIfQuery(ScenarioSpec(name="late"), n_windows=1,
                                  deadline_s=0.01))
        r = t.wait(timeout=10)
        assert not r.ok() and r.code == ErrorCode.DEADLINE_EXCEEDED
        assert "deadline" in r.error and log == []
        assert mb.metrics.snapshot()["resilience"]["deadline_missed"] == 1
    finally:
        mb.stop()


def test_bounded_queue_sheds_best_effort_not_priority():
    log = []
    mb = MicroBatcher(_ok_executor(log), max_lanes=8, max_wait_s=30,
                      metrics=ServiceMetrics(), max_pending=2)
    mb.start()
    t1 = mb.submit(WhatIfQuery(ScenarioSpec(name="a"), n_windows=1))
    t2 = mb.submit(WhatIfQuery(ScenarioSpec(name="b"), n_windows=1))
    t3 = mb.submit(WhatIfQuery(ScenarioSpec(name="c"), n_windows=1))
    assert t3.done.is_set()                    # shed NOW, typed, no waiting
    assert t3.result.code == ErrorCode.SHED and "shed" in t3.result.error
    t4 = mb.submit(WhatIfQuery(ScenarioSpec(name="vip"), n_windows=1,
                               priority=1))   # priority lane: bound exempt
    assert not t4.done.is_set()
    mb.stop(drain=True)
    for t in (t1, t2, t4):
        assert t.wait(timeout=10).ok()
    assert mb.metrics.snapshot()["resilience"]["shed"] == 1


def test_priority_bucket_launches_before_older_best_effort():
    log = []
    mb = MicroBatcher(_ok_executor(log), max_lanes=4, max_wait_s=0.01)
    ta = Ticket(WhatIfQuery(ScenarioSpec(name="old"), n_windows=1))
    tb = Ticket(WhatIfQuery(ScenarioSpec(name="vip"), n_windows=2,
                            priority=1))
    mb._buckets[ta.query.batch_key()] = [ta]   # ta is OLDER (made first)
    mb._buckets[tb.query.batch_key()] = [tb]
    mb._stop.set()                             # make every bucket eligible
    assert mb._launch_ready() and mb._launch_ready()
    assert log == [["vip"], ["old"]]           # priority beats age


def test_supervised_batcher_restarts_and_recovers():
    log = []
    mb = MicroBatcher(_ok_executor(log), max_lanes=4, max_wait_s=0.02,
                      metrics=ServiceMetrics())
    plan = FaultPlan().on("batcher_loop", "transient", times=1)
    with armed(plan):
        mb.start()
        t = mb.submit(WhatIfQuery(ScenarioSpec(name="survivor"),
                                  n_windows=1))
        r = t.wait(timeout=10)
    mb.stop()
    assert r.ok()                              # the crash lost nothing
    assert mb.metrics.snapshot()["resilience"]["batcher_restarts"] == 1


def test_batcher_gives_up_after_max_restarts():
    mb = MicroBatcher(_ok_executor([]), max_lanes=4, max_wait_s=10,
                      metrics=ServiceMetrics(), max_restarts=0)
    plan = FaultPlan().on("batcher_loop", "persistent", after=1)
    with armed(plan):
        mb.start()                             # iteration 0 is clean: blocks
        t = mb.submit(WhatIfQuery(ScenarioSpec(name="doomed"), n_windows=1))
        r = t.wait(timeout=10)                 # iteration 1 crash-loops out
    mb.stop()
    assert not r.ok() and r.code == ErrorCode.EXECUTOR_ERROR
    assert "crash-looped" in r.error
    assert mb.metrics.snapshot()["resilience"]["batcher_restarts"] == 1


# --- server chaos acceptance -------------------------------------------------

def _server(stack, cfg, **kw):
    srv = WhatIfServer(cfg, stack, schedulers=("greedy",), max_lanes=4,
                       max_wait_s=0.01, batch_windows=BW, device="cpu", **kw)
    srv.start(warm=True)
    return srv


def _direct_frame(cfg, stack, specs, n_windows):
    fleet = ScenarioFleet.from_precompiled(cfg, stack, specs,
                                           batch_windows=BW,
                                           n_windows=n_windows, device="cpu")
    fleet.run()
    return fleet.stats_frame()


def test_transient_launch_faults_absorbed_bitwise(stack, cfg):
    srv = _server(stack, cfg,
                  retry=RetryPolicy(max_retries=3, base_delay_s=0.001,
                                    max_delay_s=0.01, seed=1))
    specs = [ScenarioSpec(name="t0", scheduler="greedy"),
             ScenarioSpec(name="t1", scheduler="greedy",
                          node_outage_frac=0.25)]
    plan = (FaultPlan()
            .on("engine_launch", "transient", times=2)
            .on("chunk_load", "latency", times=2, delay_s=0.01))
    try:
        with armed(plan):
            tickets = [srv.submit(WhatIfQuery(s, n_windows=32))
                       for s in specs]
            results = [t.wait(timeout=300) for t in tickets]
        assert all(r.ok() for r in results), [r.error for r in results]
        s = srv.stats()
        assert s["resilience"]["retries"] == 2
        assert s["resilience"]["launch_failures"] == 2
        assert s["errors_by_code"] == {}
        assert plan.fired_at("engine_launch") == [("transient", 0),
                                                  ("transient", 1)]
        assert plan.fired_at("chunk_load")     # slow loads really happened
    finally:
        srv.stop()
    # graceful degradation is not enough: served-under-chaos must be bitwise
    # identical to an unfaulted direct fleet run
    frame = _direct_frame(cfg, stack, specs, 32)
    for i, (spec, r) in enumerate(zip(specs, results)):
        for k, v in r.frame.items():
            assert np.array_equal(v, frame[k][:, i]), k
        want = scenario_report([spec.name],
                               {k: v[:, i:i + 1] for k, v in frame.items()},
                               [spec.scheduler])["scenarios"][0]
        assert r.row == want


def test_fork_restore_fault_retried(stack, cfg):
    srv = _server(stack, cfg,
                  retry=RetryPolicy(max_retries=2, base_delay_s=0.001,
                                    max_delay_s=0.01))
    try:
        srv.build_fork_points([ScenarioSpec(name="trunk",
                                            scheduler="greedy")], every=BW)
        plan = FaultPlan().on("fork_restore", "transient", times=1)
        with armed(plan):
            r = srv.query(WhatIfQuery(ScenarioSpec(name="cont",
                                                   scheduler="greedy"),
                                      n_windows=BW, start_window=BW),
                          timeout=300)
        assert r.ok(), r.error
        assert srv.stats()["resilience"]["retries"] == 1
    finally:
        srv.stop()


def test_breaker_opens_fast_fails_and_recovers_bitwise(stack, cfg):
    srv = _server(stack, cfg,
                  retry=RetryPolicy(max_retries=1, base_delay_s=0.001,
                                    max_delay_s=0.01),
                  breaker=BreakerPolicy(failure_threshold=2,
                                        reset_timeout_s=5.0))
    # the program's breaker, made now on a clock the test moves; each
    # transition is logged with the completed-query count at that moment
    now, log = [0.0], []

    def on_transition(event):
        log.append((event, srv.metrics.snapshot()["completed"]))
        srv._on_breaker(event)

    breaker = srv.engines.breaker(srv._program_key(), srv.breaker_policy,
                                  on_transition=on_transition)
    breaker._clock = lambda: now[0]
    spec = ScenarioSpec(name="b", scheduler="greedy")
    try:
        with armed(FaultPlan().on("engine_launch", "persistent")):
            r1 = srv.query(WhatIfQuery(spec, n_windows=BW), timeout=60)
            r2 = srv.query(WhatIfQuery(spec, n_windows=BW), timeout=60)
            for r in (r1, r2):
                assert not r.ok() and r.code == ErrorCode.EXECUTOR_ERROR
                assert "injected persistent fault" in r.error
            s = srv.stats()["resilience"]
            assert s["breaker_opens"] == 1
            assert s["launch_failures"] == 4   # 2 queries x (1 try + 1 retry)
            assert not srv.engines.warmed      # poisoned program evicted
            # while open: fail fast, typed, no launch attempted
            now[0] = 4.9
            r3 = srv.query(WhatIfQuery(spec, n_windows=BW), timeout=60)
            assert not r3.ok() and r3.code == ErrorCode.BREAKER_OPEN
            assert srv.stats()["resilience"]["launch_failures"] == 4
        now[0] = 5.0                           # fault gone; reset timeout up
        r4 = srv.query(WhatIfQuery(spec, n_windows=BW), timeout=300)
        assert r4.ok(), r4.error               # the half-open probe
        # read straight after the probe returns: the close is counted
        s = srv.stats()
        assert s["resilience"]["breaker_probes"] == 1
        assert s["resilience"]["breaker_closes"] == 1
        assert s["errors_by_code"] == {ErrorCode.EXECUTOR_ERROR: 2,
                                       ErrorCode.BREAKER_OPEN: 1}
        # the close came before the probe's ticket was finished
        assert log == [("open", 0), ("probe", 0), ("close", 0)]
    finally:
        srv.stop()
    # post-recovery result is bitwise-identical to an unfaulted run
    frame = _direct_frame(cfg, stack, [spec], BW)
    for k, v in r4.frame.items():
        assert np.array_equal(v, frame[k][:, 0]), k


def test_server_validates_deadline_and_policies(stack, cfg):
    srv = _server(stack, cfg)
    try:
        r = srv.query(WhatIfQuery(ScenarioSpec(scheduler="greedy"),
                                  n_windows=8, deadline_s=0.0), timeout=60)
        assert not r.ok() and r.code == ErrorCode.INVALID
        assert "deadline" in r.error
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="max_retries"):
        WhatIfServer(cfg, stack, retry=RetryPolicy(max_retries=-1),
                     device="cpu")
