"""The port's what-if service: protocol, micro-batching, engine cache, fork
points, and the service against the reference's.

The port of every test in ``tests/test_service.py`` (same fixture sizes),
plus: served frames bitwise equal to a direct port fleet of the same B,
fork continuations bitwise, the same queries served by the reference's
``WhatIfServer`` (integer columns exact, floats within rtol 1e-5 / atol
1e-6), the JSON wire read by either package, and a repeated query
leaving the cached chunk and the template untouched. Everything runs on
the CPU (``device="cpu"``: the kernels' plain versions)."""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.config import REDUCED_SIM
from repro_torch.core.precompile import (load_window_range, precompile_trace,
                                         replay_config)
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.scenarios import ScenarioFleet, ScenarioSpec
from repro_torch.scenarios.report import scenario_report
from repro_torch.service import (EngineCache, MicroBatcher, ServiceMetrics,
                                 WhatIfQuery, WhatIfResult, WhatIfServer,
                                 decode_query, decode_result, encode_query,
                                 encode_result, spec_from_dict)

BW = 16          # serving chunk size == fleet batch_windows everywhere here
N_STACK = 64
TRUNK = [ScenarioSpec(name="trunk/greedy", scheduler="greedy"),
         ScenarioSpec(name="trunk/ff", scheduler="first_fit")]

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


@pytest.fixture(scope="module")
def server(stack, cfg):
    srv = WhatIfServer(cfg, stack, schedulers=("greedy", "first_fit"),
                       max_lanes=4, max_wait_s=0.05, batch_windows=BW,
                       device="cpu")
    srv.start(warm=True)
    srv.build_fork_points(TRUNK, every=BW)
    yield srv
    srv.stop()


def direct_fleet(cfg, stack, specs, n_windows):
    fleet = ScenarioFleet.from_precompiled(cfg, stack, specs,
                                           batch_windows=BW,
                                           n_windows=n_windows, device="cpu")
    fleet.run()
    return fleet


def assert_lane(frame, res, lane, rows=slice(None)):
    for k, v in res.frame.items():
        assert np.array_equal(v, frame[k][rows, lane]), k


# --- protocol ----------------------------------------------------------------

def test_protocol_roundtrip():
    q = WhatIfQuery(ScenarioSpec(name="x", scheduler="greedy",
                                 node_outage_frac=0.2),
                    n_windows=8, start_window=16, seed=3,
                    include_curves=True)
    q2 = decode_query(encode_query(q))
    assert q2 == q
    r = WhatIfResult(name="x", scheduler="greedy", start_window=16,
                     n_windows=8, row={"placements": 3}, total_s=0.5,
                     batch_lanes=2, batch_size=4)
    r2 = decode_result(encode_result(r))
    assert r2.row == r.row and r2.ok() and r2.batch_lanes == 2


def test_spec_from_dict_drops_unknown():
    s = spec_from_dict({"name": "a", "scheduler": "greedy",
                        "knob_from_the_future": 9})
    assert s == ScenarioSpec(name="a")


def test_query_validation():
    with pytest.raises(ValueError):
        WhatIfQuery(ScenarioSpec(), n_windows=0)
    with pytest.raises(ValueError):
        WhatIfQuery(ScenarioSpec(), n_windows=4, start_window=-1)
    with pytest.raises(ValueError):
        WhatIfQuery(ScenarioSpec(), n_windows=4, priority=-1)


def test_wire_crosses_packages():
    """Queries and results encoded by either package decode in the other,
    and both packages write the same bytes."""
    from repro.scenarios import ScenarioSpec as RefSpec
    from repro.service import (WhatIfQuery as RefQuery,
                               WhatIfResult as RefResult,
                               decode_query as ref_decode_query,
                               decode_result as ref_decode_result,
                               encode_query as ref_encode_query,
                               encode_result as ref_encode_result)
    kw = dict(name="x", scheduler="first_fit", node_outage_frac=0.2,
              capacity_scale=0.75, evict_storm_frac=0.05)
    q = WhatIfQuery(ScenarioSpec(**kw), n_windows=8, start_window=16,
                    seed=3, include_curves=True, deadline_s=2.5, priority=1)
    rq = RefQuery(RefSpec(**kw), n_windows=8, start_window=16, seed=3,
                  include_curves=True, deadline_s=2.5, priority=1)
    assert encode_query(q) == ref_encode_query(rq)
    assert decode_query(ref_encode_query(rq)) == q
    assert ref_decode_query(encode_query(q)) == rq
    rk = dict(name="x", scheduler="greedy", start_window=16, n_windows=8,
              row={"placements": 3, "cpu_res": 0.25},
              curves={"placements": [1, 2]}, queue_s=0.1, exec_s=0.2,
              total_s=0.3, batch_lanes=2, batch_size=4,
              error="boom", code="EXECUTOR_ERROR")
    r = WhatIfResult(**rk, frame={"placements": np.arange(3)})
    rr = RefResult(**rk)
    assert encode_result(r) == ref_encode_result(rr)
    assert decode_result(ref_encode_result(rr)) == WhatIfResult(**rk)
    assert ref_decode_result(encode_result(r)) == rr


# --- serving equivalence -----------------------------------------------------

def test_single_query_matches_direct(server, cfg, stack):
    spec = ScenarioSpec(name="q", scheduler="first_fit",
                        node_outage_frac=0.25)
    res = server.query(WhatIfQuery(spec, n_windows=32), timeout=300)
    assert res.ok(), res.error
    fleet = direct_fleet(cfg, stack, [spec], 32)
    assert_lane(fleet.stats_frame(), res, 0)
    want = fleet.report()["scenarios"][0]
    assert res.row == want


def test_three_concurrent_queries_match_direct(server, cfg, stack):
    """One fork-point query + two from window 0, submitted concurrently,
    each report matching a direct run."""
    fork_w = BW
    q_fork = WhatIfQuery(ScenarioSpec(name="cont", scheduler="greedy"),
                         n_windows=32, start_window=fork_w)
    q_a = WhatIfQuery(ScenarioSpec(name="a", scheduler="greedy",
                                   capacity_scale=0.8), n_windows=32)
    q_b = WhatIfQuery(ScenarioSpec(name="b", scheduler="first_fit",
                                   usage_scale=1.5), n_windows=32)
    tickets = [server.submit(q) for q in (q_fork, q_a, q_b)]
    res_fork, res_a, res_b = [t.wait(timeout=300) for t in tickets]
    assert all(r.ok() for r in (res_fork, res_a, res_b))

    # window-0 queries: direct single-spec fleet runs
    for q, r in ((q_a, res_a), (q_b, res_b)):
        fleet = direct_fleet(cfg, stack, [q.spec], 32)
        assert r.row == fleet.report()["scenarios"][0]

    # fork query: bitwise vs the trunk lane of a replay-from-zero run
    fleet = direct_fleet(cfg, stack, TRUNK, fork_w + 32)
    frame = fleet.stats_frame()
    assert_lane(frame, res_fork, 0, slice(fork_w, None))
    want = scenario_report(["cont"],
                           {k: v[fork_w:, :1] for k, v in frame.items()},
                           ["greedy"])["scenarios"][0]
    assert res_fork.row == want


def test_fork_point_bitwise_acceptance(server, cfg, stack):
    """Fork at window 32, run 32 more — bitwise equal to windows [32, 64)
    of the same lane replayed from zero."""
    spec = ScenarioSpec(name="late", scheduler="first_fit")
    res = server.query(WhatIfQuery(spec, n_windows=32, start_window=32),
                       timeout=300)
    assert res.ok(), res.error
    fleet = direct_fleet(cfg, stack, TRUNK, 64)
    assert_lane(fleet.stats_frame(), res, 1, slice(32, None))


def test_fork_continuations_of_both_lanes_in_one_batch(server, cfg, stack):
    """Both trunk lanes continued from window 16 in one launch (2 live + 2
    pad lanes), relabelled: each bitwise equal to its trunk lane."""
    before = server.metrics.snapshot()["batches"]
    specs = [ScenarioSpec(name="ff-cont", scheduler="first_fit"),
             ScenarioSpec(name="g-cont", scheduler="greedy")]
    tickets = [server.submit(WhatIfQuery(s, n_windows=BW, start_window=BW))
               for s in specs]
    res = [t.wait(timeout=300) for t in tickets]
    assert all(r.ok() for r in res) and {r.batch_lanes for r in res} == {2}
    assert server.metrics.snapshot()["batches"] == before + 1
    frame = direct_fleet(cfg, stack, TRUNK, 2 * BW).stats_frame()
    assert_lane(frame, res[0], 1, slice(BW, None))
    assert_lane(frame, res[1], 0, slice(BW, None))


def test_served_frames_equal_direct_fleet_of_same_b(server, cfg, stack):
    """A full batch of four strangers against a direct 4-lane fleet of the
    same specs: every column of every lane bitwise (the direct fleet drops
    the storm pass, which the server always runs: a no-op at storm 0)."""
    specs = [ScenarioSpec(name="g", scheduler="greedy"),
             ScenarioSpec(name="ff/out", scheduler="first_fit",
                          node_outage_frac=0.3),
             ScenarioSpec(name="g/surge", scheduler="greedy",
                          priority_surge_frac=0.5),
             ScenarioSpec(name="ff/thin", scheduler="first_fit",
                          arrival_rate=0.5)]
    tickets = [server.submit(WhatIfQuery(s, n_windows=32)) for s in specs]
    res = [t.wait(timeout=300) for t in tickets]
    assert {r.batch_lanes for r in res} == {4}
    fleet = direct_fleet(cfg, stack, specs, 32)
    assert not fleet._has_storm
    frame = fleet.stats_frame()
    for i, (spec, r) in enumerate(zip(specs, res)):
        assert_lane(frame, r, i)
        assert r.row == scenario_report(
            [spec.name], {k: v[:, i:i + 1] for k, v in frame.items()},
            [spec.scheduler])["scenarios"][0]


def test_repeat_query_leaves_cache_and_template_untouched(server, stack):
    spec = ScenarioSpec(name="again", scheduler="greedy",
                        capacity_scale=0.9)
    a = server.query(WhatIfQuery(spec, n_windows=BW), timeout=300)
    hits = server.engines.cache_stats()["hits"]
    b = server.query(WhatIfQuery(spec, n_windows=BW), timeout=300)
    assert server.engines.cache_stats()["hits"] == hits + 1
    for k in a.frame:
        assert np.array_equal(a.frame[k], b.frame[k]), k
    cached = server.engines.window_chunk(stack, 0, BW)
    for got, want in zip(cached, load_window_range(stack, 0, BW)):
        assert np.array_equal(got.numpy(), want)
    from repro_torch.core.state import init_state
    for got, want in zip(server.engines.template_state(),
                         init_state(server.cfg, "cpu")):
        assert torch.equal(got, want)


def test_served_matches_reference_server(server, cfg, stack):
    """The same four queries served by the reference's WhatIfServer over
    the same stack and lane count: integer columns exact, floats within
    rtol 1e-5 / atol 1e-6."""
    from repro.config import REDUCED_SIM as REF_SIM
    from repro.core.precompile import replay_config as ref_replay_config
    from repro.scenarios import ScenarioSpec as RefSpec
    from repro.service import (WhatIfQuery as RefQuery,
                               WhatIfServer as RefServer)
    kws = [dict(name="g", scheduler="greedy"),
           dict(name="ff/out", scheduler="first_fit", node_outage_frac=0.2),
           dict(name="g/cap", scheduler="greedy", capacity_scale=0.8),
           dict(name="ff/use", scheduler="first_fit", usage_scale=1.5)]
    ref = RefServer(ref_replay_config(stack, REF_SIM), stack,
                    schedulers=("greedy", "first_fit"), max_lanes=4,
                    max_wait_s=0.05, batch_windows=BW)
    ref.start(warm=False)
    try:
        ref_res = [t.wait(timeout=600) for t in
                   [ref.submit(RefQuery(RefSpec(**kw), n_windows=32))
                    for kw in kws]]
    finally:
        ref.stop()
    res = [t.wait(timeout=300) for t in
           [server.submit(WhatIfQuery(ScenarioSpec(**kw), n_windows=32))
            for kw in kws]]
    for r, rr in zip(res, ref_res):
        assert r.ok() and rr.ok() and r.batch_lanes == rr.batch_lanes == 4
        assert set(r.frame) == set(rr.frame)
        for k, want in rr.frame.items():
            got = r.frame[k]
            if want.dtype.kind in "iub":
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                           err_msg=k)


# --- micro-batching ----------------------------------------------------------

def test_strangers_coalesce_into_one_launch(server):
    before = server.metrics.snapshot()["batches"]
    specs = [ScenarioSpec(name=f"s{i}", scheduler="greedy",
                          capacity_scale=1.0 - 0.05 * i) for i in range(4)]
    tickets = [server.submit(WhatIfQuery(s, n_windows=16)) for s in specs]
    results = [t.wait(timeout=300) for t in tickets]
    assert all(r.ok() for r in results)
    # 4 strangers, max_lanes=4: they must have ridden ONE full launch
    assert server.metrics.snapshot()["batches"] == before + 1
    assert {r.batch_lanes for r in results} == {4}
    assert {r.batch_size for r in results} == {4}


def test_incompatible_keys_split_batches(server):
    before = server.metrics.snapshot()["batches"]
    t1 = server.submit(WhatIfQuery(ScenarioSpec(name="n16"), n_windows=16))
    t2 = server.submit(WhatIfQuery(ScenarioSpec(name="n32"), n_windows=32))
    r1, r2 = t1.wait(timeout=300), t2.wait(timeout=300)
    assert r1.ok() and r2.ok()
    assert r1.n_windows == 16 and r2.n_windows == 32
    assert server.metrics.snapshot()["batches"] == before + 2


def test_submit_time_errors(server):
    def err_of(q):
        r = server.query(q, timeout=60)
        assert not r.ok()
        return r.error

    assert "serving table" in err_of(
        WhatIfQuery(ScenarioSpec(scheduler="round_robin"), n_windows=8))
    assert "deadline" in err_of(
        WhatIfQuery(ScenarioSpec(), n_windows=8, deadline_s=0.0))
    assert "injection slot pool" in err_of(
        WhatIfQuery(ScenarioSpec(arrival_rate=2.0), n_windows=8))
    assert "outside the stack" in err_of(
        WhatIfQuery(ScenarioSpec(), n_windows=N_STACK + 1))
    assert "no fork point" in err_of(
        WhatIfQuery(ScenarioSpec(), n_windows=8, start_window=7))
    assert "trunk seed" in err_of(
        WhatIfQuery(ScenarioSpec(), n_windows=8, start_window=BW, seed=9))
    assert "matches no fork lane" in err_of(
        WhatIfQuery(ScenarioSpec(node_outage_frac=0.5), n_windows=8,
                    start_window=BW))


def test_metrics_and_cache_telemetry(server):
    server.query(WhatIfQuery(ScenarioSpec(name="m1"), n_windows=16),
                 timeout=300)
    s = server.stats()
    assert s["completed"] >= 1 and s["failed"] >= 1     # from the error test
    assert s["queue_depth"] == 0
    assert s["lanes_per_s"] > 0
    assert 0 < s["mean_batch_occupancy"] <= 1
    assert s["latency_p99_s"] >= s["latency_p50_s"] > 0
    wc = s["window_cache"]
    assert wc["hits"] > 0 and wc["misses"] > 0          # repeats hit the LRU
    # every cadence multiple, incl. the stack end (a fork at the final
    # window serves no continuation but costs one retained state)
    assert s["fork_windows"] == [BW, 2 * BW, 3 * BW, 4 * BW]


# --- units -------------------------------------------------------------------

def test_engine_cache_lru(stack, cfg):
    ec = EngineCache(cfg, window_cache_chunks=2, device="cpu")
    ec.window_chunk(stack, 0, BW)
    ec.window_chunk(stack, 0, BW)
    assert ec.cache_stats() == {"hits": 1, "misses": 1, "cached_chunks": 1}
    ec.window_chunk(stack, BW, 2 * BW)
    ec.window_chunk(stack, 2 * BW, 3 * BW)     # evicts (0, BW)
    assert ec.cache_stats()["cached_chunks"] == 2
    ec.window_chunk(stack, 0, BW)              # miss again after eviction
    assert ec.cache_stats()["misses"] == 4


def test_fork_point_store_bounded(cfg):
    from repro_torch.core.state import init_state, lift
    from repro_torch.service import ForkPointStore
    specs = [ScenarioSpec(name="t", scheduler="greedy")]
    state = lift(init_state(cfg, "cpu"))
    with pytest.raises(ValueError):
        ForkPointStore(max_points=0)
    store = ForkPointStore(max_points=3)
    for w in (32, 64, 96, 128, 160):
        store.add(w, state, specs)
        assert len(store.windows) <= 3
    # oldest evicted first; the frontier survives
    assert store.windows == [96, 128, 160]
    with pytest.raises(KeyError):
        store.get(32)
    assert store.nearest_at_or_before(100) == 96
    with pytest.raises(ValueError, match="lanes"):
        store.add(192, state, specs * 2)
    unbounded = ForkPointStore()
    for w in (32, 64, 96, 128, 160):
        unbounded.add(w, state, specs)
    assert len(unbounded.windows) == 5


def test_fresh_lanes_own_their_storage(cfg):
    ec = EngineCache(cfg, device="cpu")
    lanes = ec.fresh_lanes(3)
    lanes.node_reserved[1].fill_(7.0)
    lanes.task_node[0, 0] = 5
    assert float(lanes.node_reserved[0].abs().sum()) == 0.0
    assert int(lanes.task_node[1, 0]) == -1
    assert float(ec.template_state().node_reserved.abs().sum()) == 0.0
    assert int(ec.template_state().task_node[0]) == -1


def test_batcher_without_simulator():
    """The batcher is simulator-agnostic: a dummy executor sees coalesced
    buckets, errors don't wedge waiters, stop() drains."""
    launches = []

    def execute(tickets):
        launches.append(len(tickets))
        for t in tickets:
            if t.query.spec.name == "boom":
                raise RuntimeError("kaboom")
            t.finish(WhatIfResult(name=t.query.spec.name, scheduler="greedy",
                                  start_window=0, n_windows=1, row={}))

    mb = MicroBatcher(execute, max_lanes=3, max_wait_s=0.02,
                      metrics=ServiceMetrics())
    mb.start()
    ts = [mb.submit(WhatIfQuery(ScenarioSpec(name=f"s{i}"), n_windows=1))
          for i in range(3)]
    for t in ts:
        assert t.wait(timeout=10).ok()
    assert launches[0] == 3                      # full bucket, one launch

    t_err = mb.submit(WhatIfQuery(ScenarioSpec(name="boom"), n_windows=1))
    r = t_err.wait(timeout=10)                   # aged partial bucket
    assert not r.ok() and "kaboom" in r.error

    t_last = mb.submit(WhatIfQuery(ScenarioSpec(name="tail"), n_windows=1))
    mb.stop(drain=True)                          # drains without the wait
    assert t_last.wait(timeout=10).ok()
    m = mb.metrics.snapshot()
    assert m["submitted"] == 5 and m["completed"] == 4 and m["failed"] == 1


# --- the CLI -----------------------------------------------------------------

def test_serve_cli_on_the_cpu_under_chaos(capsys):
    from repro_torch.launch import serve_whatif
    results = serve_whatif.main([
        "--nodes", "32", "--jobs", "60", "--windows", "64",
        "--schedulers", "greedy", "--max-lanes", "4", "--batch-windows",
        "32", "--query-windows", "32", "--fork-every", "32",
        "--chaos", "engine_launch:transient:2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "errors by code: {}" in text and "'retries': 2" in text
    assert "fork points at windows [32, 64]" in text
    assert len(results) == 3 and all(r.ok() for r in results)
    assert results[-1].start_window == 32 and results[-1].batch_lanes == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_whatif.main(["--nodes", "32", "--windows", "8"])
