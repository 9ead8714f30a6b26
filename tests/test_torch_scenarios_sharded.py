"""The mesh-sharded scenario fleet of the port (``fleet_mesh``,
``run_scenarios_sharded``, ``ScenarioFleet(mesh=)``) on the CPU, the
counterpart of ``tests/test_scenarios_sharded.py``: sharding must be a pure
layout change, with padding lanes invisible.

* B=5 (the reference's five specs) over a world of 1 gloo rank, in
  process, on grid-aligned windows (multiples of 1/128): the reference's
  unsharded ``ScenarioFleet`` and its 1-device ``fleet_mesh()`` fleet
  against the port's sharded fleet, every state field exact and every
  stats column and report entry bitwise but the two balance variances,
  which the port sums in f64 and rounds once (ROADMAP Queue 3) and which
  stay within the parity bar of ``tests/test_torch_scenarios.py`` (rtol
  5e-7); the port's sharded fleet against its unsharded one, every column
  and field bitwise, ``report()`` equal; a sharded snapshot restored into
  an unsharded fleet, bitwise.
* B=64 over 8 gloo ranks (``torch.multiprocessing.spawn``, a ``file://``
  store under ``tmp_path``), the reference's acceptance grid on a tracegen
  trace: every lane bitwise its lane of the port's unsharded fleet, and
  ``injected_arrivals`` > 0; B=5 over the same 8 ranks: 3 padding lanes,
  invisible in stats, report and snapshot, and a snapshot restored under
  the mesh.
* Two ranks: swap invariance (a lane's result depends only on its own
  knobs), the guards (B not divisible by the mesh, ``sched_dispatch=
  'table'``), and ``whatif --mesh 2`` against the unsharded CLI.

Every in-process world of 1 is destroyed in a ``finally``, so no process
group leaks into the next test. The 8-rank tests keep the reference's
``slow`` mark (``-m "not slow"`` deselects them; the full suite runs
them).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.config import REDUCED_SIM
from repro_torch.core import tracegen
from repro_torch.core.events import EventKind, HostEvent, pack_window
from repro_torch.core.snapshot import load_snapshot
from repro_torch.core.state import state_to_numpy
from repro_torch.parsers import GCDParser
from repro_torch.scenarios import (ScenarioFleet, ScenarioSpec, expand_grid,
                                   fleet_mesh)
from repro_torch.scenarios import batch as batch_mod

torch.set_num_threads(1)

CFG = dataclasses.replace(REDUCED_SIM, inject_slots=16, inject_task_slots=64)
CFG64 = dataclasses.replace(REDUCED_SIM, inject_slots=16,
                            inject_task_slots=128)
VARS = ("util_balance_var", "reserved_balance_var")
VAR_RTOL = 5e-7        # port vs reference variances (f64 sums, see above)
FIVE = [dict(name="base"), dict(name="amp", arrival_rate=2.0),
        dict(name="outage", node_outage_frac=0.25),
        dict(name="ff", scheduler="first_fit"),
        dict(name="storm", evict_storm_frac=0.05)]
GRID64 = dict(scheduler=["greedy", "first_fit"],
              arrival_rate=[0.5, 1.0, 1.5, 2.0],
              node_outage_frac=[0.0, 0.1, 0.2, 0.3],
              capacity_scale=[1.0, 0.8])


def _g(r, lo, hi):
    return float(r.integers(lo, hi)) / 128


def _grid_events(seed, n_windows=12, n_nodes=12, n_slots=120):
    """Grid-aligned host events, so float sums are exact in both packages:
    node adds and updates, task adds, usage samples, requirement updates
    and removals."""
    r = np.random.default_rng(seed)
    wins = [[HostEvent(0, EventKind.ADD_NODE, m,
                       a=(_g(r, 48, 160), _g(r, 48, 160), _g(r, 48, 160)))
             for m in range(n_nodes)]]
    for _ in range(n_windows - 1):
        evs = []
        for slot in r.choice(n_slots, 30, replace=False):
            k = int(r.choice([1, 1, 1, 2, 3, 5]))
            a = (_g(r, 1, 24), _g(r, 1, 24), _g(r, 0, 8))
            if k == 1:
                evs.append(HostEvent(1, EventKind.ADD_TASK, int(slot), a=a,
                                     prio=int(r.integers(0, 12))))
            elif k == 2:
                evs.append(HostEvent(1, EventKind.UPDATE_TASK_REQUIRED,
                                     int(slot), a=a,
                                     prio=int(r.integers(0, 12))))
            elif k == 3:
                evs.append(HostEvent(2, EventKind.UPDATE_TASK_USED, int(slot),
                                     u=tuple(_g(r, 0, 16) for _ in range(8))))
            else:
                evs.append(HostEvent(2, EventKind.REMOVE_TASK, int(slot),
                                     a=(0.0, 0, 0)))
        wins.append(evs)
    return wins


def _frames_equal(got, want, bar=False):
    """Every column bitwise; with ``bar`` the variance columns within the
    port-versus-reference parity bar instead."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if bar and k in VARS:
            np.testing.assert_allclose(g, w, rtol=VAR_RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _reports_equal(got, want):
    """Report entries equal; those of the variances within VAR_RTOL."""
    got, want = _report_json(got), _report_json(want)
    assert got.keys() == want.keys()
    assert len(got["scenarios"]) == len(want["scenarios"])
    for g, w in zip(got["scenarios"], want["scenarios"]):
        assert g.keys() == w.keys()
        for k in w:
            if "_var" in k:
                np.testing.assert_allclose(g[k], w[k], rtol=VAR_RTOL,
                                           err_msg=k)
            else:
                assert g[k] == w[k], (g["scenario"], k)


def _states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


def _trace_fleet(cfg, trace_dir, specs, mesh=None, n_windows=16,
                 batch_windows=8):
    fleet = ScenarioFleet(
        cfg, GCDParser(cfg, trace_dir).packed_windows(
            n_windows, start_us=tracegen.SHIFT_US - cfg.window_us),
        specs, batch_windows=batch_windows, mesh=mesh, device="cpu")
    fleet.run()
    return fleet


def _report_json(report):
    return json.loads(json.dumps(report))


# --- a world of 1, in process, against the reference -------------------------

def test_world_of_one_matches_reference_fleets_and_unsharded(tmp_path):
    import jax
    from repro.config import REDUCED_SIM as REF_REDUCED
    from repro.core.events import pack_window as ref_pack_window
    from repro.scenarios import ScenarioFleet as RefFleet
    from repro.scenarios import ScenarioSpec as RefSpec
    from repro.scenarios import fleet_mesh as ref_fleet_mesh

    ref_cfg = dataclasses.replace(REF_REDUCED, inject_slots=16,
                                  inject_task_slots=64)
    wins = _grid_events(3)
    port_ws = [pack_window(CFG, e, i) for i, e in enumerate(wins)]
    ref_ws = [ref_pack_window(ref_cfg, e, i) for i, e in enumerate(wins)]
    specs = [ScenarioSpec(**s) for s in FIVE]
    rspecs = [RefSpec(**s) for s in FIVE]
    refs = {}
    for label, mesh in (("plain", None), ("mesh", ref_fleet_mesh())):
        f = RefFleet(ref_cfg, iter(ref_ws), rspecs, batch_windows=5,
                     mesh=mesh)
        f.run()
        refs[label] = (f.stats_frame(), jax.tree.map(
            np.asarray, f.state)._asdict(), f.report())
    plain = ScenarioFleet(CFG, iter(port_ws), specs, batch_windows=5,
                          device="cpu")
    plain.run()
    assert not dist.is_initialized()
    try:
        mesh = fleet_mesh(1, device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        sharded = ScenarioFleet(CFG, iter(port_ws), specs, batch_windows=5,
                                mesh=mesh, device="cpu")
        assert sharded.n_lanes == sharded.n_scenarios == 5
        assert sharded._lane_scheds is None          # the switch path
        sharded.run()
        frame, state = sharded.stats_frame(), state_to_numpy(sharded.state)
        path = str(tmp_path / "sharded.npz")
        sharded.save(path)
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            fleet_mesh(2, device="cpu")
        table = dataclasses.replace(CFG, sched_dispatch="table")
        with pytest.raises(ValueError, match="incompatible with mesh"):
            ScenarioFleet(table, iter(port_ws), specs, mesh=mesh,
                          device="cpu").run()
    finally:
        dist.destroy_process_group()
    assert sharded.report()["scenarios"][1]["injected"] > 0
    for rframe, rstate, rreport in refs.values():
        _frames_equal(frame, rframe, bar=True)
        _states_equal(state, rstate)
        _reports_equal(sharded.report(), rreport)
    # against the port's unsharded (switchless) fleet: bitwise throughout
    _frames_equal(frame, plain.stats_frame())
    _states_equal(state, state_to_numpy(plain.state))
    assert sharded.report() == plain.report()
    back = ScenarioFleet(CFG, iter(()), specs, device="cpu")
    back.restore(path)
    _states_equal(state_to_numpy(back.state), state_to_numpy(plain.state))
    assert back.windows_done == plain.windows_done == len(wins)


def test_whatif_cli_mesh_one_equals_unsharded(capsys):
    from repro_torch.launch import whatif
    flags = ["--nodes", "24", "--jobs", "30", "--windows", "12",
             "--schedulers", "greedy,first_fit", "--outage", "0,0.2",
             "--arrival", "1.0,1.5", "--batch-windows", "6",
             "--device", "cpu"]
    want = whatif.main(flags)
    capsys.readouterr()
    got = whatif.main(flags + ["--mesh", "1"])
    text = capsys.readouterr().out
    assert not dist.is_initialized()             # the CLI ended its world
    assert "mesh: 1 devices over ('data',)" in text
    assert "8 device lanes" in text
    assert got == want
    with pytest.raises(SystemExit) as e:
        whatif.main(flags + ["--mesh", "3"])
    assert e.value.code == 2 and not dist.is_initialized()
    assert "torchrun --nproc-per-node 3" in capsys.readouterr().err


# --- several gloo ranks, spawned ---------------------------------------------

def _rank_main(rank, world, store, job, out, trace_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = fleet_mesh(world, device="cpu")
        assert mesh.get_local_rank("data") == rank
        JOBS[job](rank, mesh, out, trace_dir)
    finally:
        dist.destroy_process_group()


def _save_frame(fleet, path):
    np.savez(path, **fleet.stats_frame())


def _job_eight(rank, mesh, out, trace_dir):
    specs = expand_grid(**GRID64)
    fleet = _trace_fleet(CFG64, trace_dir, specs, mesh)
    assert fleet.n_lanes == 64 and fleet.state.window.shape[0] == 8
    fleet.save(os.path.join(out, "b64.npz"))
    if rank == 0:
        _save_frame(fleet, os.path.join(out, "b64_frame.npz"))
    five = [ScenarioSpec(**s) for s in FIVE]
    pad = _trace_fleet(CFG64, trace_dir, five, mesh)
    assert pad.n_scenarios == 5 and pad.n_lanes == 8
    assert pad.state.window.shape[0] == 1           # one lane a rank
    # the pad lanes reuse the first spec's scheduler: the table holds two
    assert pad.scheduler_names == ("greedy", "first_fit")
    pad.save(os.path.join(out, "b5.npz"))
    # a snapshot restored under the mesh: a real lane as it was, a padding
    # lane an empty world again (the snapshot holds the real lanes only)
    again = ScenarioFleet(CFG64, iter(()), five, mesh=mesh, device="cpu")
    again.restore(os.path.join(out, "b5.npz"))
    want = pad.state if rank < 5 else batch_mod.init_batched_state(
        CFG64, 1, "cpu")
    for f in again.state._fields:
        assert torch.equal(getattr(again.state, f),
                           getattr(want, f)), (rank, f)
    frames = [None] * mesh.size()
    dist.all_gather_object(frames, pad.stats_frame())
    for fr in frames:
        _frames_equal(fr, frames[0])                 # equal on every rank
    if rank == 0:
        _save_frame(pad, os.path.join(out, "b5_frame.npz"))
        with open(os.path.join(out, "b5_report.json"), "w") as f:
            json.dump(pad.report(), f)


def _job_two(rank, mesh, out, trace_dir):
    base = ScenarioSpec(name="base")
    amp = ScenarioSpec(name="amp", arrival_rate=2.0)
    a = _trace_fleet(CFG, trace_dir, [base, amp], mesh, n_windows=12)
    b = _trace_fleet(CFG, trace_dir, [amp, base], mesh, n_windows=12)
    fa, fb = a.stats_frame(), b.stats_frame()
    for k in fa:
        np.testing.assert_array_equal(fa[k][:, 0], fb[k][:, 1], err_msg=k)
        np.testing.assert_array_equal(fa[k][:, 1], fb[k][:, 0], err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        batch_mod.init_batched_state(CFG, 3, "cpu", mesh)
    with pytest.raises(ValueError, match="not divisible"):
        batch_mod.shard_over_fleet(a.knobs._replace(
            sched_idx=torch.zeros(3, dtype=torch.int32)), mesh)
    table = dataclasses.replace(CFG, sched_dispatch="table")
    with pytest.raises(ValueError, match="incompatible with mesh"):
        batch_mod.run_scenarios_sharded(a.state, _first_windows(trace_dir),
                                        a.knobs, table, a.scheduler_names,
                                        mesh)
    from repro_torch.launch import whatif
    report = whatif.main(["--nodes", "24", "--jobs", "30", "--windows", "12",
                          "--schedulers", "greedy,first_fit", "--outage",
                          "0,0.2,0.4", "--batch-windows", "6", "--device",
                          "cpu", "--mesh", "2"])
    with open(os.path.join(out, f"whatif_{rank}.json"), "w") as f:
        json.dump(report, f)


def _first_windows(trace_dir):
    from repro_torch.core.events import stack_windows, window_to_torch
    ws = list(GCDParser(CFG, trace_dir).packed_windows(
        2, start_us=tracegen.SHIFT_US - CFG.window_us))
    return window_to_torch(stack_windows(ws), "cpu")


JOBS = {"eight": _job_eight, "two": _job_two}


def _spawn(world, job, tmp_path, trace_dir):
    out = tmp_path / job
    out.mkdir()
    mp.spawn(_rank_main, args=(world, str(tmp_path / f"store_{job}"), job,
                               str(out), trace_dir),
             nprocs=world, join=True)
    return out


def _trace(tmp_path, **kw):
    d = str(tmp_path / "trace")
    tracegen.generate_trace(d, n_machines=24, n_jobs=40,
                            usage_period_us=10_000_000, **kw)
    return d


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eight")
    trace_dir = _trace(tmp, horizon_windows=12, seed=29)
    return _spawn(8, "eight", tmp, trace_dir), trace_dir


@pytest.mark.slow
def test_sharded_b64_over_eight_ranks_is_the_unsharded_fleet(eight_ranks):
    """Acceptance: B=64 over 8 gloo ranks == the port's unsharded fleet,
    every lane, every stats column and every state field, bitwise."""
    out, trace_dir = eight_ranks
    ref = _trace_fleet(CFG64, trace_dir, expand_grid(**GRID64))
    frame = dict(np.load(out / "b64_frame.npz"))
    _frames_equal(frame, ref.stats_frame())
    assert frame["injected_arrivals"].sum() > 0
    snap = load_snapshot(str(out / "b64.npz"), device="cpu")
    assert snap.state.window.shape[0] == 64 and snap.windows_done == 16
    _states_equal(state_to_numpy(snap.state), state_to_numpy(ref.state))


@pytest.mark.slow
def test_padding_lanes_are_invisible_over_eight_ranks(eight_ranks):
    """B=5 over 8 ranks: 3 padding lanes, invisible in the stats, the
    report and the snapshot (which restores into an unsharded fleet)."""
    out, trace_dir = eight_ranks
    five = [ScenarioSpec(**s) for s in FIVE]
    ref = _trace_fleet(CFG64, trace_dir, five)
    frame = dict(np.load(out / "b5_frame.npz"))
    assert all(v.shape[1] == 5 for v in frame.values())
    _frames_equal(frame, ref.stats_frame())
    with open(out / "b5_report.json") as f:
        assert json.load(f) == _report_json(ref.report())
    snap = load_snapshot(str(out / "b5.npz"), device="cpu")
    assert snap.state.window.shape[0] == 5
    assert snap.extra["scenario_names"] == [s.name for s in five]
    back = ScenarioFleet(CFG64, iter(()), five, device="cpu")
    back.restore(str(out / "b5.npz"))
    _states_equal(state_to_numpy(back.state), state_to_numpy(ref.state))


def test_two_ranks_swap_invariance_guards_and_cli(tmp_path, capsys):
    """Lanes never communicate: swapping two lanes over two ranks swaps
    their results. The guards raise on every rank; ``whatif --mesh 2``
    reports what the unsharded CLI reports, on both ranks."""
    trace_dir = _trace(tmp_path, horizon_windows=10, seed=31)
    out = _spawn(2, "two", tmp_path, trace_dir)
    from repro_torch.launch import whatif
    want = whatif.main(["--nodes", "24", "--jobs", "30", "--windows", "12",
                        "--schedulers", "greedy,first_fit", "--outage",
                        "0,0.2,0.4", "--batch-windows", "6", "--device",
                        "cpu"])
    for rank in range(2):
        with open(out / f"whatif_{rank}.json") as f:
            assert json.load(f) == _report_json(want), rank
