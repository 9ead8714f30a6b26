"""The port's scheduler fleets (``core/fleet.run_fleet``), the detachable
monitor (``core/monitor``) and the drivers' batch hooks (``on_batch``,
``pause``/``resume``), against the reference where it has a counterpart.
The ports of ``tests/test_fleet_monitor.py``'s checks, on the CPU."""
import dataclasses
import os
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import REDUCED_SIM as REF_CFG
from repro.core import engine as ref_engine
from repro.core import fleet as ref_fleet
from repro.core import monitor as ref_monitor
from repro.core.events import (HostEvent as RefHostEvent,
                               pack_window as ref_pack_window,
                               stack_windows as ref_stack_windows)
from repro.core.snapshot import save_snapshot as ref_save_snapshot
from repro.core.state import SimState as RefState
from repro.core.state import init_state as ref_init_state
from repro.sched import get_scheduler as ref_get_scheduler
from repro_torch.config import REDUCED_SIM as CFG
from repro_torch.core import engine, fleet, monitor
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.pipeline import Simulation
from repro_torch.core.snapshot import save_snapshot
from repro_torch.core.state import (drop, init_state, lift,
                                    state_from_numpy, state_to_numpy,
                                    validate_invariants)
from repro_torch.core.tracegen import generate_trace
from repro_torch.parsers import GCDParser, default_start_us
from repro_torch.sched import get_scheduler

torch.set_num_threads(1)


def _events(n_nodes=8, n_tasks=24, seed=0):
    r = np.random.default_rng(seed)
    evs0 = [(0, EventKind.ADD_NODE, i, dict(a=(1.0, 1.0, 1.0)))
            for i in range(n_nodes)]
    evs1 = [(1, EventKind.ADD_TASK, t,
             dict(a=(float(r.uniform(.05, .3)), float(r.uniform(.05, .3)),
                     0.0), prio=int(r.integers(0, 12))))
            for t in range(n_tasks)]
    return evs0, evs1


def _windows():
    """The reference test's two windows, packed by the port (tensors)."""
    evs0, evs1 = _events()
    ws = [pack_window(CFG, [HostEvent(t, k, s, **kw) for t, k, s, kw in e],
                      i) for i, e in enumerate((evs0, evs1))]
    return window_to_torch(stack_windows(ws), "cpu")


def _ref_windows():
    evs0, evs1 = _events()
    ws = [ref_pack_window(REF_CFG, [RefHostEvent(t, int(k), s, **kw)
                                    for t, k, s, kw in e], i)
          for i, e in enumerate((evs0, evs1))]
    return jax.tree.map(jnp.asarray, ref_stack_windows(ws))


def _replica(states, i):
    return type(states)(*[x[i] for x in states])


# --- run_fleet ---------------------------------------------------------------

def test_fleet_replicas_differ_but_hold_invariants():
    states, stats = fleet.run_fleet(_windows(), CFG, "random", n_replicas=4)
    assert stats["placements"].shape == (4, 2)
    assert (stats["placements"][:, -1] > 0).all()
    nodes = states.task_node.numpy()
    assert not (nodes[0] == nodes[1]).all()       # different key streams
    for i in range(4):
        assert validate_invariants(_replica(states, i), CFG) == {}


def test_fleet_deterministic():
    a = fleet.run_fleet(_windows(), CFG, "random", n_replicas=2, seed=7)
    b = fleet.run_fleet(_windows(), CFG, "random", n_replicas=2, seed=7)
    assert torch.equal(a[0].task_node, b[0].task_node)


def test_fleet_replica_is_run_windows_seeded_seed_plus_i():
    windows = _windows()
    states, stats = fleet.run_fleet(windows, CFG, "random", n_replicas=3,
                                    seed=5)
    for i in range(3):
        st, rows = engine.run_windows(init_state(CFG, "cpu"), windows, CFG,
                                      get_scheduler("random"), seed=5 + i)
        for f in st._fields:
            assert torch.equal(getattr(states, f)[i], getattr(st, f)), f
        for k, v in rows.items():
            assert torch.equal(stats[k][i], v), k
    with pytest.raises(ValueError, match="seeds"):
        fleet.fleet_fn(CFG, "random", 2)(windows, [0])


def test_fleet_matches_reference():
    """``run_fleet("random")`` against the reference's vmapped fleet: states
    and integer stats exact, float stats within rtol 1e-5."""
    states, stats = fleet.run_fleet(_windows(), CFG, "random", n_replicas=4,
                                    seed=3)
    ref_states, ref_stats = ref_fleet.run_fleet(_ref_windows(), REF_CFG,
                                                "random", n_replicas=4,
                                                seed=3)
    got = state_to_numpy(states)
    for f, v in ref_states._asdict().items():
        np.testing.assert_array_equal(got[f], np.asarray(v), err_msg=f)
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        want = np.asarray(v)
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(stats[k].numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(stats[k].numpy(), want, rtol=1e-5,
                                       err_msg=k)


# --- the monitor -------------------------------------------------------------

def _greedy_state():
    state, _ = engine.run_windows(init_state(CFG, "cpu"), _windows(), CFG,
                                  get_scheduler("greedy"))
    return state


def test_monitor_render_equals_reference():
    state = _greedy_state()
    text = monitor.render(state, CFG, windows_done=2)
    assert "tasks running" in text and "cpu  reserved" in text
    assert "busiest nodes" in text
    ref_state = RefState(**{k: jnp.asarray(v)
                            for k, v in state_to_numpy(state).items()})
    assert text == ref_monitor.render(ref_state, REF_CFG, windows_done=2)
    # and a reference state carried over into the port renders the same
    ref_run, _ = ref_engine.run_windows(ref_init_state(REF_CFG),
                                        _ref_windows(), REF_CFG,
                                        ref_get_scheduler("greedy"))
    carried = state_from_numpy(
        {k: np.asarray(v) for k, v in ref_run._asdict().items()}, "cpu")
    assert monitor.render(carried, CFG, 2) == \
        ref_monitor.render(ref_run, REF_CFG, 2)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_watch_snapshot_polls_either_package(writer, capsys):
    state = _greedy_state()
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "snap.npz")
        if writer == "port":
            save_snapshot(p, state, CFG, 2)
        else:
            ref_save_snapshot(p, RefState(**{
                k: jnp.asarray(v) for k, v in state_to_numpy(state).items()}),
                REF_CFG, 2)
        monitor.watch_snapshot(p, interval=0.01, iterations=1)
    out = capsys.readouterr().out
    assert monitor.render(state, CFG, 2) in out


# --- the drivers' batch hooks ------------------------------------------------

@pytest.fixture(scope="module")
def trace_windows():
    cfg = CFG
    with tempfile.TemporaryDirectory() as d:
        generate_trace(d, n_machines=16, n_jobs=40, horizon_windows=24,
                       seed=3, usage_period_us=10_000_000)
        return list(GCDParser(cfg, d).packed_windows(
            24, start_us=default_start_us("gcd", cfg)))


def test_on_batch_called_once_a_batch_after_the_resync(trace_windows):
    cfg = dataclasses.replace(CFG, resync_windows=8)
    seen = []

    def on_batch(sim):
        fresh = drop(engine.recompute_accounting(
            lift(type(sim.state)(*[x.clone() for x in sim.state])), cfg))
        seen.append((sim.windows_done, sim.resyncs_done,
                     torch.equal(fresh.node_reserved,
                                 sim.state.node_reserved)))

    sim = Simulation(cfg, iter(trace_windows), scheduler="greedy",
                     batch_windows=4, device="cpu")
    sim.run(on_batch=on_batch)
    assert [s[:2] for s in seen] == [(4, 0), (8, 1), (12, 1), (16, 2),
                                     (20, 2), (24, 3)]
    # at each resync batch the hook sees the freshly recomputed tallies
    assert all(ok for w, _, ok in seen if w % 8 == 0)


def test_pause_from_another_thread_holds_the_loop(trace_windows):
    straight = Simulation(CFG, iter(trace_windows), scheduler="greedy",
                          batch_windows=4, device="cpu")
    straight.run()
    sim = Simulation(CFG, iter(trace_windows), scheduler="greedy",
                     batch_windows=4, device="cpu")
    first, held = threading.Event(), threading.Event()

    def on_batch(s):
        if s.windows_done == 4:
            first.set()
            assert held.wait(10)        # the loop goes on once paused

    runner = threading.Thread(target=sim.run, kwargs={"on_batch": on_batch})
    runner.start()
    try:
        assert first.wait(30)
        sim.pause()
        held.set()
        done = sim.windows_done
        time.sleep(0.2)
        assert sim.windows_done == done == 4
        assert runner.is_alive()
    finally:
        sim.resume()
        runner.join(60)
    assert not runner.is_alive()
    assert sim.windows_done == straight.windows_done == 24
    for f in sim.state._fields:
        assert torch.equal(getattr(sim.state, f),
                           getattr(straight.state, f)), f


def test_monitor_attach_renders_every_k_batches(trace_windows, capsys):
    sim = Simulation(CFG, iter(trace_windows), scheduler="greedy",
                     batch_windows=4, device="cpu")
    sim.run(on_batch=monitor.attach(sim, every_batches=2))
    out = capsys.readouterr().out
    assert out.count("AGOCS simulation monitor") == 3
    assert "window 8 " in out and "window 24 " in out
    assert monitor.render(sim.state, CFG, 24) in out
