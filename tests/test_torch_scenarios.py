"""The scenario fleet of the port against the reference's, on the CPU.

* Every knob of ``perturb`` (outage, thinning, surge, usage, capacity,
  injection, expiry, storms capped and uncapped) on the same numpy-made
  window or state, the port's lanes against the reference's transform
  vmapped over the same knobs: integers exact, floats bitwise.
* ``run_scenarios`` on a mixed fleet (every ported scheduler, a storm lane,
  an amplified lane, a lane of every knob) over grid-aligned windows
  (multiples of 1/128, so every sum is exact in f32): the switch and
  switchless paths against each other bitwise, and against the
  reference's ``run_scenarios`` lane for lane — state and counters exact,
  float stats bitwise, the ratio fields within rtol 2.5e-7 — at stats
  strides 1 and 3. The variances: the port's (f64 sums, rounded once) are
  held within rtol 2.5e-7 of an f64 recomputation, and the reference's
  vmapped f32 sums are up to 3.4e-7 off that value on these windows (its
  own rounding, ROADMAP Queue 3), so port and reference agree within
  rtol 5e-7, the sum of two such errors.
* Lane 0 against the port's own ``Simulation``; a tracegen trace through
  both packages' parsers and ``ScenarioFleet``s; the ``whatif`` CLI on the
  CPU; the entry points that wait for later slices.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import REDUCED_SIM as REF_REDUCED
from repro.core import tracegen as ref_tracegen
from repro.core.events import pack_window as ref_pack_window
from repro.core.state import init_state as ref_init_state
from repro.parsers import GCDParser as RefGCDParser
from repro.parsers import default_start_us as ref_start_us
from repro.scenarios import ScenarioFleet as RefFleet
from repro.scenarios import ScenarioSpec as RefSpec
from repro.scenarios import batch as ref_batch
from repro.scenarios import build_knobs as ref_build_knobs
from repro.scenarios import perturb as ref_perturb
from repro.sched import snapshot_dispatch as ref_snapshot
from repro_torch.config import REDUCED_SIM
from repro_torch.core import tracegen
from repro_torch.core.pipeline import Simulation
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import (state_from_numpy, state_to_numpy,
                                    validate_invariants)
from repro_torch.parsers import GCDParser, default_start_us
from repro_torch.scenarios import (ScenarioFleet, ScenarioSpec, build_knobs,
                                   expand_grid)
from repro_torch.scenarios import batch as batch_mod
from repro_torch.scenarios import perturb
from repro_torch.sched import snapshot_dispatch

torch.set_num_threads(1)

SHAPE = dict(inject_slots=16, inject_task_slots=64)
CFG = dataclasses.replace(REDUCED_SIM, **SHAPE)
REF_CFG = dataclasses.replace(REF_REDUCED, **SHAPE)
VARS = ("util_balance_var", "reserved_balance_var")
RATIOS = ("reserved_frac", "used_frac", "overestimate_frac", "usage_mean")
RTOL = 2.5e-7
VAR_RTOL = 5e-7        # port vs reference variances, see the module doc
N_WINDOWS = 8

# the reference's MIXED_SPECS (tests/test_sched_dispatch.py) without its
# RNG schedulers, plus one lane of every other knob, grid-preserving values
MIXED = (
    [dict(name=f"b-{s}", scheduler=s)
     for s in ("greedy", "first_fit", "round_robin")]
    + [dict(name="storm", scheduler="greedy", evict_storm_frac=0.2),
       dict(name="amp", scheduler="round_robin", arrival_rate=2.0),
       dict(name="knobs", scheduler="first_fit", node_outage_frac=0.2,
            capacity_scale=1.5, arrival_rate=0.75, priority_surge_frac=0.3,
            surge_priority=9, usage_scale=2.0)])


def _g(r, lo, hi):
    return float(r.integers(lo, hi)) / 128


def _events(seed, n_windows=N_WINDOWS, n_nodes=12, n_slots=120):
    """Grid-aligned host events: node adds and updates, task adds, usage
    samples, requirement updates and removals."""
    r = np.random.default_rng(seed)
    wins = [[HostEvent(0, EventKind.ADD_NODE, m,
                       a=(_g(r, 48, 160), _g(r, 48, 160), _g(r, 48, 160)))
             for m in range(n_nodes)]]
    for _ in range(n_windows - 1):
        evs = []
        for slot in r.choice(n_slots, 30, replace=False):
            k = int(r.choice([1, 1, 1, 2, 3, 5]))
            if k == 1:
                evs.append(HostEvent(1, EventKind.ADD_TASK, int(slot),
                                     a=(_g(r, 1, 24), _g(r, 1, 24),
                                        _g(r, 0, 8)),
                                     prio=int(r.integers(0, 12))))
            elif k == 2:
                evs.append(HostEvent(1, EventKind.UPDATE_TASK_REQUIRED,
                                     int(slot), a=(_g(r, 1, 24), _g(r, 1, 24),
                                                   _g(r, 0, 8)),
                                     prio=int(r.integers(0, 12))))
            elif k == 3:
                evs.append(HostEvent(2, EventKind.UPDATE_TASK_USED, int(slot),
                                     u=tuple(_g(r, 0, 16) for _ in range(8))))
            else:
                evs.append(HostEvent(2, EventKind.REMOVE_TASK, int(slot),
                                     a=(0.0, 0, 0)))
        if r.random() < 0.4:
            evs.append(HostEvent(0, EventKind.UPDATE_NODE_RESOURCES,
                                 int(r.integers(0, n_nodes)),
                                 a=(_g(r, 48, 160), _g(r, 48, 160),
                                    _g(r, 48, 160))))
        wins.append(evs)
    return wins


def _stack(cfg, wins, packer=pack_window):
    return stack_windows([packer(cfg, e, i) for i, e in enumerate(wins)])


def _ref_fleet(specs):
    rspecs = [RefSpec(**s) for s in specs]
    knobs, names = ref_build_knobs(rspecs)
    return rspecs, knobs, names


def _port_fleet(specs):
    pspecs = [ScenarioSpec(**s) for s in specs]
    knobs, names = build_knobs(pspecs)
    return pspecs, knobs, names


def _assert_rows(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k in VARS:
            np.testing.assert_allclose(g, w, rtol=VAR_RTOL, atol=0,
                                       err_msg=k)
        elif k in RATIOS:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_state(got, want):
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


# --- perturb, knob by knob ---------------------------------------------------

KNOBS = {
    "outage": dict(node_outage_frac=0.4),
    "thinning": dict(arrival_rate=0.5),
    "surge": dict(priority_surge_frac=0.5, surge_priority=7),
    "usage": dict(usage_scale=2.5),
    "capacity": dict(capacity_scale=0.75),
    "injection": dict(arrival_rate=1.75),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_perturb_window_matches_reference(knob):
    specs = [dict(name="id"), dict(name=knob, **KNOBS[knob]),
             dict(name=knob + "2", **KNOBS[knob], scheduler="first_fit")]
    wins = _events(11, n_windows=3)
    wins[1] += [HostEvent(0, EventKind.ADD_NODE, m, a=(1.0, 0.5, 0.25))
                for m in range(12)]
    rspecs, rknobs, _ = _ref_fleet(specs)
    _, knobs, _ = _port_fleet(specs)
    for j, evs in enumerate(wins):
        w_np = ref_pack_window(REF_CFG, evs, j)
        window = np.array([j, j + 5, 3 * j], np.int32)
        want = jax.vmap(lambda k, wi: ref_perturb.perturb_window(
            jax.tree.map(jnp.asarray, w_np), k, REF_CFG, window=wi))(
                rknobs, jnp.asarray(window))
        got = perturb.perturb_window(window_to_torch(w_np, "cpu"), knobs,
                                     CFG, window=torch.from_numpy(window))
        for f, g, w in zip(type(got)._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{knob}: {f}")
    if knob == "injection":
        assert int((got.kind[1, -CFG.inject_slots:] == 1).sum()) > 0


def _busy_state(seed, cfg):
    """A reference state with running tasks on active nodes and live
    injected clones in the reserved pool (grid-aligned values)."""
    r = np.random.default_rng(seed)
    s = {k: np.asarray(v) for k, v in ref_init_state(REF_CFG)._asdict()
         .items()}
    T, N = cfg.max_tasks, cfg.max_nodes
    s["node_active"] = np.ones(N, bool)
    s["node_total"] = (r.integers(256, 512, (N, 3)) / 128).astype(np.float32)
    s["task_state"] = r.choice([0, 1, 2, 2], T).astype(np.int8)
    s["task_node"] = np.where(s["task_state"] == 2, r.integers(0, N, T),
                              -1).astype(np.int32)
    s["task_req"] = (r.integers(1, 16, (T, 3)) / 128).astype(np.float32)
    s["task_usage"] = (r.integers(0, 16, (T, 8)) / 128).astype(np.float32)
    run = s["task_state"] == 2
    res = np.zeros((N, 3), np.float32)
    np.add.at(res, s["task_node"][run], s["task_req"][run])
    s["node_reserved"] = res
    use = np.zeros((N, 3), np.float32)
    np.add.at(use, s["task_node"][run], s["task_usage"][run][:, [0, 1, 5]])
    s["node_used"] = use
    s["window"] = np.int32(9)
    return s


def _lanes_pair(s, B):
    ref = type(ref_init_state(REF_CFG))(
        **{k: jnp.asarray(np.broadcast_to(v, (B,) + np.shape(v)))
           for k, v in s.items()})
    port = state_from_numpy({k: np.broadcast_to(v, (B,) + np.shape(v))
                             for k, v in s.items()}, "cpu")
    return ref, port


@pytest.mark.parametrize("case", ["expiry", "storm_capped",
                                  "storm_uncapped", "storm_full_accounting"])
def test_state_perturbations_match_reference(case):
    cfg_over = {"storm_uncapped": dict(storm_max_victims=10 ** 6),
                "storm_capped": dict(storm_max_victims=40),
                "storm_full_accounting": dict(incremental_accounting=False)
                }.get(case, {})
    cfg = dataclasses.replace(CFG, **cfg_over)
    ref_cfg = dataclasses.replace(REF_CFG, **cfg_over)
    if case == "expiry":
        specs = [dict(name="id"), dict(name="amp", arrival_rate=2.0),
                 dict(name="amp3", arrival_rate=3.0)]
        ref_fn, port_fn = ref_perturb.expire_injected, perturb.expire_injected
    else:
        specs = [dict(name="calm"), dict(name="s", evict_storm_frac=0.3),
                 dict(name="all", evict_storm_frac=1.0)]
        ref_fn, port_fn = ref_perturb.storm_evict, perturb.storm_evict
    _, rknobs, _ = _ref_fleet(specs)
    _, knobs, _ = _port_fleet(specs)
    s = _busy_state(5, cfg)
    for window in (9, 23, 40):
        s["window"] = np.int32(window)
        ref, port = _lanes_pair(s, len(specs))
        want = jax.vmap(lambda st, k: ref_fn(st, k, ref_cfg))(ref, rknobs)
        got = port_fn(port, knobs, cfg)
        _assert_state(state_to_numpy(got),
                      {k: np.asarray(v) for k, v in want._asdict().items()})
    moved = state_to_numpy(got)
    assert (moved["task_state"][1] != moved["task_state"][0]).any(), case


# --- the fleet ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_runs():
    """Reference fleet states and stats over the mixed specs, strides 1 and
    3, switchless dispatch (the reference's two paths agree bitwise)."""
    wins = _events(0)
    windows = _stack(REF_CFG, wins, ref_pack_window)
    rspecs, rknobs, rnames = _ref_fleet(MIXED)
    lane = tuple(rnames.index(s.scheduler) for s in rspecs)
    out = {}
    for stride in (1, 3):
        cfg = dataclasses.replace(REF_CFG, stats_stride=stride)
        state, rows = ref_batch.run_scenarios_jit(
            ref_batch.init_batched_state(cfg, len(rspecs)),
            jax.tree.map(jnp.asarray, windows), rknobs, cfg, rnames, 0,
            True, ref_snapshot(rnames), lane)
        out[stride] = ({k: np.asarray(v) for k, v in state._asdict().items()},
                       {k: np.asarray(v) for k, v in rows.items()})
    return _stack(CFG, wins), out


def _run_port(windows, specs, cfg, switchless):
    _, knobs, names = _port_fleet(specs)
    lane = tuple(names.index(s["scheduler"]) if "scheduler" in s else 0
                 for s in specs) if switchless else None
    state = batch_mod.init_batched_state(cfg, len(specs), "cpu")
    return batch_mod.run_scenarios(state, window_to_torch(windows, "cpu"),
                                   knobs, cfg, names, 0, True,
                                   snapshot_dispatch(names), lane)


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("dispatch", ["table", "switch"])
def test_run_scenarios_matches_reference(mixed_runs, dispatch, stride):
    windows, runs = mixed_runs
    want_state, want_rows = runs[stride]
    cfg = dataclasses.replace(CFG, stats_stride=stride,
                              sched_dispatch="auto" if dispatch == "table"
                              else "switch")
    state, rows = _run_port(windows, MIXED, cfg, dispatch == "table")
    _assert_state(state_to_numpy(state), want_state)
    _assert_rows({k: v.numpy() for k, v in rows.items()}, want_rows)
    _assert_variances_near_exact(state, rows)
    placed = rows["placements"][-1].numpy()
    assert (placed > 0).all()
    injected = rows["injected_arrivals"].numpy().sum(0)
    assert injected[4] > 0 and injected[:4].sum() == 0
    if stride == 1:
        assert rows["evictions"][-1, 3] > rows["evictions"][-1, 0]


def _assert_variances_near_exact(state, rows):
    """The last row's variances within RTOL of f64 sums of the per-node
    values the stats take (the mean rounded to f32 first, as both packages
    do)."""
    s = state_to_numpy(state)
    for b in range(s["node_active"].shape[0]):
        act = s["node_active"][b]
        n = max(int(act.sum()), 1)
        tot = s["node_total"][b]
        util = np.where(act, s["node_used"][b][:, 0]
                        / np.maximum(tot[:, 0], np.float32(1e-9)), 0)
        frac = np.where(act[:, None], s["node_reserved"][b]
                        / np.maximum(tot, np.float32(1e-9)), 0)
        frac = ((frac[:, 0] + frac[:, 1]) + frac[:, 2]) * np.float32(1 / 3)
        for key, x in (("util_balance_var", util),
                       ("reserved_balance_var", frac)):
            x = x.astype(np.float32).astype(np.float64)
            mean = np.float32(x.sum() / n)
            exact = (np.where(act, (x - mean) ** 2, 0).sum()) / n
            np.testing.assert_allclose(rows[key][-1, b].item(), exact,
                                       rtol=RTOL, atol=1e-12,
                                       err_msg=f"{key} lane {b}")


def test_switch_and_switchless_paths_match_bitwise():
    windows = _stack(CFG, _events(4))
    table, _ = _run_port(windows, MIXED, CFG, True)
    switch, _ = _run_port(windows, MIXED,
                          dataclasses.replace(CFG, sched_dispatch="switch"),
                          True)
    for f in table._fields:
        assert torch.equal(getattr(table, f), getattr(switch, f)), f


def test_lane0_matches_simulation():
    """Lane 0 (identity knobs, greedy) of a ScenarioFleet equals the port's
    Simulation over the same windows: state and stats rows bitwise (both
    drivers batch 3 windows and resync every 6)."""
    cfg = dataclasses.replace(CFG, resync_windows=6)
    windows = _stack(cfg, _events(2))
    source = lambda: (type(windows)(*[f[j] for f in windows])
                      for j in range(N_WINDOWS))
    fleet = ScenarioFleet(cfg, source(), [ScenarioSpec(**s) for s in MIXED],
                          batch_windows=3, device="cpu")
    fleet.run()
    sim = Simulation(cfg, source(), scheduler="greedy", batch_windows=3,
                     device="cpu")
    sim.run()
    assert fleet.resyncs_done == sim.resyncs_done == 1
    for f in sim.state._fields:
        assert torch.equal(getattr(fleet.state, f)[0],
                           getattr(sim.state, f)), f
    rows, srows = fleet.stats_frame(), sim.stats_frame()
    for k, v in srows.items():
        np.testing.assert_array_equal(rows[k][:, 0], v, err_msg=k)


def test_fleets_match_on_a_tracegen_trace(tmp_path):
    """One tracegen trace, each package's own parser and ScenarioFleet
    (batch_windows 8, a resync inside the run): decisions and integers
    exact, floats within rtol 1e-5 (off the grid)."""
    n_windows = 32
    shape = dict(max_nodes=24, max_tasks=512, max_events_per_window=256,
                 sched_batch=32, resync_windows=16, inject_slots=32)
    cfg = dataclasses.replace(REDUCED_SIM, **shape)
    ref_cfg = dataclasses.replace(REF_REDUCED, **shape)
    kw = dict(n_machines=24, n_jobs=60, horizon_windows=n_windows, seed=7,
              usage_period_us=20_000_000)
    tracegen.generate_trace(str(tmp_path / "p"), **kw)
    ref_tracegen.generate_trace(str(tmp_path / "r"), **kw)
    specs = [dict(name="g"), dict(name="ff", scheduler="first_fit"),
             dict(name="amp", scheduler="round_robin", arrival_rate=1.5),
             dict(name="storm", evict_storm_frac=0.05)]
    ref = RefFleet(ref_cfg, RefGCDParser(ref_cfg, str(tmp_path / "r"))
                   .packed_windows(n_windows, ref_start_us("gcd", ref_cfg)),
                   [RefSpec(**s) for s in specs], batch_windows=8)
    ref.run()
    port = ScenarioFleet(cfg, GCDParser(cfg, str(tmp_path / "p"))
                         .packed_windows(n_windows,
                                         default_start_us("gcd", cfg)),
                         [ScenarioSpec(**s) for s in specs], batch_windows=8,
                         device="cpu")
    port.run()
    assert port.resyncs_done == ref.resyncs_done == 2
    np.testing.assert_array_equal(port.stats_window_indices(),
                                  ref.stats_window_indices())
    got, want = port.stats_frame(), ref.stats_frame()
    for k in want:
        if want[k].dtype.kind in "iub":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    ref_state = {k: np.asarray(v) for k, v in ref.state._asdict().items()}
    port_state = state_to_numpy(port.state)
    for k in ("task_state", "task_node", "node_active", "placements",
              "evictions", "completions"):
        np.testing.assert_array_equal(port_state[k], ref_state[k], err_msg=k)
    for b in range(len(specs)):
        lane = type(port.state)(*[x[b] for x in port.state])
        assert validate_invariants(lane, cfg) == {}, specs[b]["name"]
    assert port.report()["scenarios"][2]["injected"] > 0


def test_whatif_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import whatif
    out = tmp_path / "report.json"
    report = whatif.main(["--nodes", "32", "--jobs", "40", "--windows", "30",
                          "--schedulers", "greedy,first_fit",
                          "--outage", "0,0.2", "--device", "cpu",
                          "--json", str(out)])
    text = capsys.readouterr().out
    assert "4 scenarios" in text and "greedy/outage=0.2" in text
    assert len(report["scenarios"]) == 4 and out.exists()
    assert report["scenarios"][0]["placements"] > 0
    for flag in (["--mesh", "2"], ["--serve"]):
        with pytest.raises(SystemExit) as e:
            whatif.main(["--device", "cpu"] + flag)
        assert e.value.code != 0, flag
    # the replay flags run: pre-compile + snapshot, then a replay from a
    # window inside the stack
    stack, snap = tmp_path / "stack.npz", tmp_path / "fleet.npz"
    small = ["--nodes", "32", "--jobs", "40", "--windows", "12",
             "--schedulers", "greedy,random", "--device", "cpu"]
    whatif.main(small + ["--precompile", str(stack), "--snapshot",
                         str(snap)])
    assert stack.exists() and snap.exists()
    capsys.readouterr()
    report = whatif.main(small + ["--replay", str(stack), "--start-window",
                                  "4"])
    text = capsys.readouterr().out
    assert "zero parses" in text and "simulated 8 windows" in text
    assert len(report["scenarios"]) == 2


def test_entry_points_that_wait_for_later_slices():
    specs = [ScenarioSpec()]
    with pytest.raises(NotImplementedError, match="mesh"):
        ScenarioFleet(CFG, iter(()), specs, mesh=object(), device="cpu")
    # snapshots, pre-compiled replay and the RNG schedulers have landed
    fleet = ScenarioFleet(CFG, iter(()), specs, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fleet.npz")
        fleet.save(path)
        again = ScenarioFleet(CFG, iter(()), specs, device="cpu")
        again.restore(path)
        for f in fleet.state._fields:
            assert torch.equal(getattr(again.state, f),
                               getattr(fleet.state, f)), f
        stack = os.path.join(d, "stack.npz")
        from repro_torch.core.precompile import precompile_stream
        precompile_stream(CFG, iter(()), stack, 0)
        assert ScenarioFleet.from_precompiled(CFG, stack, specs,
                                              device="cpu").specs == specs
    assert ScenarioSpec(scheduler="random").scheduler == "random"
    with pytest.raises(ValueError, match="unknown scheduler"):
        ScenarioSpec(scheduler="no_such_scheduler")
    with pytest.raises(ValueError, match="inject_slots"):
        ScenarioFleet(REDUCED_SIM, iter(()),
                      [ScenarioSpec(arrival_rate=2.0)], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ScenarioFleet(CFG, iter(()), specs)


def test_expand_grid_and_knobs_match_reference():
    axes = dict(scheduler=["greedy", "round_robin"], outage=[0.0, 0.25],
                storm=[0.0, 0.125])
    mine = expand_grid(**axes)
    from repro.scenarios import expand_grid as ref_expand
    from repro.scenarios.spec import build_knobs_for_table as \
        ref_build_knobs_for_table
    from repro.scenarios.spec import one_factor_sweep as ref_one_factor_sweep
    from repro_torch.scenarios.spec import (build_knobs_for_table,
                                            one_factor_sweep)
    ref = ref_expand(**axes)
    assert [dataclasses.asdict(s) for s in mine] == \
        [dataclasses.asdict(s) for s in ref]
    assert [s.describe() for s in mine] == [s.describe() for s in ref]
    knobs, names = build_knobs(mine)
    rknobs, rnames = ref_build_knobs(ref)
    assert names == rnames
    table = ("first_fit", "round_robin", "greedy")
    for a_knobs, b_knobs in ((knobs, rknobs),
                             (build_knobs_for_table(mine, table),
                              ref_build_knobs_for_table(ref, table))):
        for f, a, b in zip(a_knobs._fields, a_knobs, b_knobs):
            assert a.numpy().dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    with pytest.raises(ValueError, match="serving table"):
        build_knobs_for_table(mine, ("greedy",))
    sweep = dict(outage=[0.0, 0.25], scheduler=["first_fit"])
    assert [dataclasses.asdict(s) for s in one_factor_sweep(**sweep)] == \
        [dataclasses.asdict(s) for s in ref_one_factor_sweep(**sweep)]
