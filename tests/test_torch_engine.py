"""The slice as a whole: the port's engine and driver against the
reference's, on the same packed windows.

* A random grid-aligned event soup (values multiples of 1/128, so every
  sum both sides take is exact in f32) goes through both ``run_windows``
  for greedy / first_fit / round_robin in both accounting modes; the final
  state and every stats row are compared (integers and sums exact, ratio
  and variance fields within rtol 2.5e-7). The port also runs at
  ``stats_stride`` 8, whose rows must be every 8th stride-1 row plus a
  final partial one.
* One small tracegen trace goes through both packages' GCD parsers and
  ``Simulation``s (batch_windows 8, a resync inside the run).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import REDUCED_SIM as REF_REDUCED
from repro.core import engine as ref_engine
from repro.core import tracegen as ref_tracegen
from repro.core.pipeline import Simulation as RefSimulation
from repro.core.state import init_state as ref_init_state
from repro.core.state import validate_invariants as ref_validate
from repro.parsers import GCDParser as RefGCDParser
from repro.parsers import default_start_us as ref_start_us
from repro.sched import get_scheduler as ref_get_scheduler
from repro_torch.config import REDUCED_SIM
from repro_torch.core import engine
from repro_torch.core import tracegen
from repro_torch.core.events import (EventKind, HostEvent,
                                     REMOVE_REASON_EVICT, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.pipeline import Simulation
from repro_torch.core.state import (init_state, state_from_numpy,
                                    state_to_numpy, validate_invariants)
from repro_torch.parsers import GCDParser, default_start_us
from repro_torch.sched import get_scheduler

torch.set_num_threads(1)

SHAPE = dict(max_nodes=16, max_tasks=96, max_events_per_window=64,
             sched_batch=24)
CFG = dataclasses.replace(REDUCED_SIM, **SHAPE)
REF_CFG = dataclasses.replace(REF_REDUCED, **SHAPE)
RATIOS = ("reserved_frac", "used_frac", "overestimate_frac", "usage_mean",
          "util_balance_var", "reserved_balance_var")
RTOL = 2.5e-7          # about 2 ulp
N_WINDOWS = 10


def _grid(r, lo, hi, q=128):
    return float(r.integers(lo, hi)) / q


def _stream(seed, n_windows=N_WINDOWS, n_nodes=10, n_slots=48, cfg=CFG):
    """Random grid-aligned event soup exercising every delta path: adds,
    removals (incl. EVICT reason), requirement updates on running tasks,
    usage samples, node churn, capacity updates, attrs + constraints."""
    r = np.random.default_rng(seed)
    windows = [[HostEvent(0, EventKind.ADD_NODE, m,
                          a=(_grid(r, 64, 256), _grid(r, 64, 256),
                             _grid(r, 64, 256)))
                for m in range(n_nodes)]]
    for _ in range(n_windows - 1):
        evs = []
        for _ in range(int(r.integers(4, 24))):
            kind = int(r.choice([1, 1, 1, 2, 3, 3, 5, 6, 7, 8, 10],
                                p=[.18, .18, .18, .08, .1, .1, .08, .03,
                                   .03, .02, .02]))
            slot = int(r.integers(0, n_slots))
            if kind == 1:
                cons = ([(int(r.integers(0, 4)), int(r.integers(1, 5)),
                          int(r.integers(0, 3)))]
                        if r.random() < 0.25 else None)
                evs.append(HostEvent(1, EventKind.ADD_TASK, slot,
                                     a=(_grid(r, 1, 48), _grid(r, 1, 48),
                                        _grid(r, 0, 16)),
                                     prio=int(r.integers(0, 12)),
                                     constraints=cons))
            elif kind == 2:
                evs.append(HostEvent(1, EventKind.UPDATE_TASK_REQUIRED, slot,
                                     a=(_grid(r, 1, 48), _grid(r, 1, 48),
                                        _grid(r, 0, 16)),
                                     prio=int(r.integers(0, 12))))
            elif kind == 3:
                evs.append(HostEvent(2, EventKind.UPDATE_TASK_USED, slot,
                                     u=tuple(_grid(r, 0, 32)
                                             for _ in range(8))))
            elif kind == 5:
                reason = (float(REMOVE_REASON_EVICT)
                          if r.random() < 0.3 else 0.0)
                evs.append(HostEvent(2, EventKind.REMOVE_TASK, slot,
                                     a=(reason, 0, 0)))
            elif kind == 6:
                evs.append(HostEvent(0, EventKind.ADD_NODE,
                                     int(r.integers(0, n_nodes)),
                                     a=(_grid(r, 64, 256), _grid(r, 64, 256),
                                        _grid(r, 64, 256))))
            elif kind == 7:
                evs.append(HostEvent(0, EventKind.UPDATE_NODE_RESOURCES,
                                     int(r.integers(0, n_nodes)),
                                     a=(_grid(r, 16, 256), _grid(r, 16, 256),
                                        _grid(r, 16, 256))))
            elif kind == 8:
                evs.append(HostEvent(0, EventKind.ADD_NODE_ATTR,
                                     int(r.integers(0, n_nodes)),
                                     attr_idx=int(r.integers(0, 4)),
                                     attr_val=int(r.integers(0, 3))))
            else:
                evs.append(HostEvent(0, EventKind.REMOVE_NODE,
                                     int(r.integers(0, n_nodes))))
        windows.append(evs)
    return stack_windows([pack_window(cfg, evs, i)
                          for i, evs in enumerate(windows)])


def _assert_rows(got, want, rtol_floats=0.0):
    """Integers exact; ratio/variance fields within RTOL; other floats
    bitwise (grid data) or within ``rtol_floats``."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in RATIOS or rtol_floats:
            np.testing.assert_allclose(g, w, rtol=max(RTOL, rtol_floats),
                                       atol=1e-7 if rtol_floats else 0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_states(got, want, rtol_floats=0.0):
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        if rtol_floats and w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol_floats, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def ref_runs():
    """Reference final states and stride-1 stats rows, one jit per case."""
    out = {}
    windows = _stream(0)
    for incremental in (True, False):
        cfg = dataclasses.replace(REF_CFG,
                                  incremental_accounting=incremental)
        for name in ("greedy", "first_fit", "round_robin"):
            state, stats = ref_engine.run_windows_jit(
                ref_init_state(cfg), jax.tree.map(jnp.asarray, windows),
                cfg, name)
            out[name, incremental] = (
                {k: np.asarray(v) for k, v in state._asdict().items()},
                {k: np.asarray(v) for k, v in stats.items()})
    return windows, out


@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("scheduler", ["greedy", "first_fit", "round_robin"])
def test_run_windows_matches_reference(ref_runs, scheduler, incremental,
                                       stride):
    windows, runs = ref_runs
    want_state, want_rows = runs[scheduler, incremental]
    cfg = dataclasses.replace(CFG, incremental_accounting=incremental,
                              stats_stride=stride)
    state, rows = engine.run_windows(init_state(cfg, "cpu"),
                                     window_to_torch(windows, "cpu"), cfg,
                                     get_scheduler(scheduler))
    _assert_states(state_to_numpy(state), want_state)
    keep = (list(range(stride - 1, N_WINDOWS, stride))
            + ([N_WINDOWS - 1] if N_WINDOWS % stride else []))
    _assert_rows({k: v.numpy() for k, v in rows.items()},
                 {k: v[keep] for k, v in want_rows.items()})
    assert validate_invariants(state, cfg) == {}


def test_state_round_trip_and_window_step():
    """state_from_numpy/state_to_numpy keep dtypes and values, and one
    make_window_step call equals the reference's."""
    windows = _stream(3, n_windows=2)
    ref_step = jax.jit(ref_engine.make_window_step(
        REF_CFG, ref_get_scheduler("greedy")))
    s0 = ref_init_state(REF_CFG)
    key = jax.random.PRNGKey(0)
    port = state_from_numpy({k: np.asarray(v) for k, v in
                             s0._asdict().items()}, "cpu")
    step = engine.make_window_step(CFG, get_scheduler("greedy"))
    for j in range(2):
        w = jax.tree.map(lambda x: jnp.asarray(x[j]), windows)
        s0, want_row = ref_step(s0, w, key)
        port, row = step(port, window_to_torch(
            type(windows)(*[f[j] for f in windows]), "cpu"))
    got = state_to_numpy(port)
    for k, v in s0._asdict().items():
        assert got[k].dtype == np.asarray(v).dtype, k
    _assert_states(got, {k: np.asarray(v) for k, v in s0._asdict().items()})
    _assert_rows({k: v.numpy() for k, v in row.items()},
                 {k: np.asarray(v) for k, v in want_row.items()})


def test_simulation_matches_reference_end_to_end(tmp_path):
    """One tracegen trace, each package's own parser and Simulation:
    batch_windows 8, resync every 16 windows, 40 windows."""
    n_windows, shape = 40, dict(max_nodes=24, max_tasks=512,
                                max_events_per_window=256, sched_batch=32,
                                resync_windows=16)
    cfg = dataclasses.replace(REDUCED_SIM, **shape)
    ref_cfg = dataclasses.replace(REF_REDUCED, **shape)
    d_port, d_ref = tmp_path / "port", tmp_path / "ref"
    kw = dict(n_machines=24, n_jobs=60, horizon_windows=n_windows, seed=5,
              usage_period_us=20_000_000)
    assert dataclasses.asdict(tracegen.generate_trace(str(d_port), **kw)) \
        == dataclasses.asdict(ref_tracegen.generate_trace(str(d_ref), **kw))
    for name in ("machine_events", "task_events", "task_usage"):
        f = f"{name}-00000-of-00001.csv"
        assert (d_port / f).read_text() == (d_ref / f).read_text(), name

    ref_sim = RefSimulation(ref_cfg, RefGCDParser(ref_cfg, str(d_ref))
                            .packed_windows(n_windows,
                                            ref_start_us("gcd", ref_cfg)),
                            scheduler="greedy", batch_windows=8)
    ref_state = ref_sim.run()
    parser = GCDParser(cfg, str(d_port))
    sim = Simulation(cfg, parser.packed_windows(
        n_windows, default_start_us("gcd", cfg)), scheduler="greedy",
        batch_windows=8, device="cpu")
    state = sim.run()
    assert sim.resyncs_done == ref_sim.resyncs_done == 2
    np.testing.assert_array_equal(sim.stats_window_indices(),
                                  ref_sim.stats_window_indices())
    # off the grid: decisions and integers exact, floats within rtol 1e-5
    _assert_rows(sim.stats_frame(), ref_sim.stats_frame(), rtol_floats=1e-5)
    _assert_states(state_to_numpy(state),
                   {k: np.asarray(v) for k, v in ref_state._asdict().items()},
                   rtol_floats=1e-5)
    assert validate_invariants(state, cfg) == ref_validate(ref_state,
                                                           ref_cfg) == {}


def test_entry_points_raise_without_a_card():
    """The card is the default: without one, and without device="cpu",
    Simulation and the CLI raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(CFG, iter(()), scheduler="greedy")
    from repro_torch.launch import simulate
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate.main(["--nodes", "8", "--jobs", "4", "--windows", "2"])


def test_rng_schedulers_wait_for_their_slice():
    """The slice they waited for has landed: every built-in of the
    reference's registry resolves, in the reference's order, and an unknown
    name still raises."""
    from repro.sched import SCHEDULERS as REF_SCHEDULERS
    from repro_torch.sched import SCHEDULERS, list_schedulers
    import repro_torch.sched.registry as registry
    assert not hasattr(registry, "NOT_PORTED")
    for name in ("random", "simulated_annealing", "tabu_search", "genetic"):
        assert get_scheduler(name).__name__ == name
    builtins = ["greedy", "first_fit", "round_robin", "random",
                "simulated_annealing", "tabu_search", "genetic"]
    assert [e.name for e in list_schedulers()][:7] == builtins
    assert list(SCHEDULERS)[:7] == list(REF_SCHEDULERS)[:7] == builtins
    with pytest.raises(KeyError):
        get_scheduler("no_such_scheduler")


@pytest.mark.parametrize("done,batch,every", [(0, 32, 64), (96, 32, 64),
                                              (40, 8, 20), (7, 3, 0)])
def test_restored_resync_phase_matches_reference(done, batch, every):
    from repro.core.pipeline import restored_resync_phase as ref_phase
    from repro_torch.core.pipeline import restored_resync_phase
    assert restored_resync_phase(done, batch, every) == \
        ref_phase(done, batch, every)


def test_row_scatters_follow_the_drop_semantics():
    """set_rows_: the last unmasked row aimed at a slot wins, masked and
    out-of-range rows are dropped; add_rows: duplicates all add."""
    from repro_torch.core.scatter import add_rows, set_rows_
    dst = torch.arange(6, dtype=torch.int32) * 10
    rows = torch.tensor([2, 2, 2, 5, 9, -1, 0])
    mask = torch.tensor([True, True, False, True, True, True, False])
    set_rows_(dst, rows, mask, torch.tensor([7, 8, 99, 5, 6, 4, 3]))
    assert dst.tolist() == [0, 10, 8, 30, 40, 5]
    acc = torch.zeros(3, 2)
    out = add_rows(acc, torch.tensor([1, 1, 2, 7]),
                   torch.tensor([True, True, False, True]),
                   torch.ones(4, 2))
    assert out.tolist() == [[0, 0], [2, 2], [0, 0]]
