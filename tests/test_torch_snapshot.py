"""The port's simulator snapshots (``repro_torch.core.snapshot``), the checks
of the reference's ``tests/test_snapshot_ckpt.py`` (its simulator half):
pause, snapshot, restore and run on equals the straight run — here under
``simulated_annealing`` too, whose keys derive from ``seed +
windows_done`` — config drift tolerance, ``extra`` returned as written, and
a fleet resumed from a pre-compiled stack at its snapshot's window equal to
the uninterrupted fleet in every state field and trailing stats row.
Across the packages: a snapshot written by either loads in the other."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.config import REDUCED_SIM
from repro_torch.core.pipeline import Simulation
from repro_torch.core.precompile import precompile_trace
from repro_torch.core.snapshot import load_snapshot, save_snapshot
from repro_torch.core.state import SimState, init_state
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.parsers.gcd import GCDParser
from repro_torch.scenarios import ScenarioFleet, expand_grid

torch.set_num_threads(1)

CFG = REDUCED_SIM
START = SHIFT_US - CFG.window_us


@pytest.mark.parametrize("scheduler", ["greedy", "simulated_annealing"])
def test_sim_snapshot_resume_equality(tmp_path, scheduler):
    """Pause at window 20, snapshot, restore, run to 40 == straight run to
    40. The resumed driver keeps its seed: each batch's keys derive from
    seed + windows_done, the uninterrupted run's seed for that batch. A
    snapshot whose state does not fit the driver is refused."""
    d = str(tmp_path)
    generate_trace(d, n_machines=16, n_jobs=25, horizon_windows=40, seed=7,
                   usage_period_us=10_000_000)

    def windows():
        return GCDParser(CFG, d).packed_windows(40, start_us=START)

    def sim(src):
        return Simulation(CFG, src, scheduler=scheduler, batch_windows=10,
                          seed=11, device="cpu")

    state_a = sim(windows()).run()
    b1 = sim(windows())
    b1.run(max_windows=20)
    assert b1.windows_done == 20
    snap = os.path.join(d, "snap.npz")
    save_snapshot(snap, b1.state, CFG, b1.windows_done)
    state_r, cfg_r, done, extra = load_snapshot(snap, device="cpu")
    assert done == 20 and cfg_r == CFG and extra == {}
    src = windows()
    for _ in range(done):
        next(src)
    b2 = sim(src)
    b2.restore(snap)
    assert b2.windows_done == done
    state_b = b2.run(max_windows=40)
    assert b2.windows_done == 40
    for f in SimState._fields:
        assert torch.equal(getattr(state_a, f), getattr(state_b, f)), f
    wider = dataclasses.replace(CFG, max_nodes=CFG.max_nodes * 2)
    with pytest.raises(ValueError, match="shape"):
        Simulation(wider, iter(()), device="cpu").restore(snap)


def _doctor_meta(path, mutate):
    """Rewrite a snapshot's __meta__ JSON in place (drift simulation)."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"]))
    mutate(meta)
    with open(path, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)


def test_snapshot_cfg_drift_tolerance(tmp_path):
    snap = str(tmp_path / "snap.npz")
    save_snapshot(snap, init_state(CFG, "cpu"), CFG, 5)

    def mutate(meta):
        meta["cfg"]["from_the_future_flag"] = 7    # newer writer
        del meta["cfg"]["sched_batch"]             # older writer

    _doctor_meta(snap, mutate)
    state, cfg, done, extra = load_snapshot(snap, device="cpu")
    assert done == 5
    assert extra["dropped_cfg_keys"] == ["from_the_future_flag"]
    assert cfg.sched_batch == type(CFG)().sched_batch
    assert cfg.max_nodes == CFG.max_nodes


def test_snapshot_extra_roundtrip_and_layout(tmp_path):
    snap = str(tmp_path / "snap.npz")
    extra = {"scenario_names": ["a", "b"], "note": "trunk@32", "k": 3}
    state = init_state(CFG, "cpu")
    save_snapshot(snap, state, CFG, 0, extra=extra)
    got = load_snapshot(snap, device="cpu")
    assert got.extra == extra
    # 0-d counters stay 0-d; every field keeps its dtype
    for f in SimState._fields:
        assert getattr(got.state, f).shape == getattr(state, f).shape, f
        assert getattr(got.state, f).dtype == getattr(state, f).dtype, f
    assert got.state.window.dim() == 0
    with np.load(snap) as z:
        meta = json.loads(str(z["__meta__"]))
        assert set(meta) == {"cfg", "windows_done", "extra", "crc"}
        assert sorted(k for k in z.files if k != "__meta__") == sorted(
            f"state/{f}" for f in SimState._fields)


def test_snapshots_load_across_packages(tmp_path):
    """Written by either package, loaded by the other: the same arrays,
    dtypes, 0-d counters, config and extra; both verify the crc32s."""
    import jax.numpy as jnp
    from repro.config import REDUCED_SIM as REF_CFG
    from repro.core.snapshot import load_snapshot as ref_load
    from repro.core.snapshot import save_snapshot as ref_save
    from repro.core.state import SimState as RefState
    r = np.random.default_rng(0)
    base, host = init_state(CFG, "cpu"), {}
    for f in SimState._fields:
        v = getattr(base, f).numpy()
        host[f] = np.asarray(
            r.random(v.shape) < 0.5 if v.dtype.kind == "b" else
            r.integers(-3, 9, v.shape) if v.dtype.kind in "iu" else
            r.random(v.shape)).astype(v.dtype)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    save_snapshot(mine, SimState(**{f: torch.as_tensor(v)
                                     for f, v in host.items()}), CFG, 9,
                  extra={"who": "port"})
    ref_save(theirs, RefState(**{f: jnp.asarray(v) for f, v in host.items()}),
             REF_CFG, 9, extra={"who": "ref"})
    a = ref_load(mine)
    b = load_snapshot(theirs, device="cpu")
    assert a.windows_done == b.windows_done == 9
    assert a.extra == {"who": "port"} and b.extra == {"who": "ref"}
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
    for f in SimState._fields:
        want = host[f]
        for got in (np.asarray(getattr(a.state, f)),
                    getattr(b.state, f).numpy()):
            assert got.dtype == want.dtype and got.shape == want.shape, f
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("schedulers", [("greedy", "first_fit"),
                                        ("simulated_annealing", "genetic")],
                         ids=["deterministic", "stochastic"])
def test_fleet_snapshot_resume_bitwise(tmp_path, schedulers):
    """B-lane fleet: run 10 windows, save, restore into a fresh fleet fed
    from the stack's window 10, run on — final state and trailing stats
    rows bitwise match the uninterrupted 30-window run."""
    d = str(tmp_path)
    generate_trace(d, n_machines=16, n_jobs=30, horizon_windows=30, seed=11,
                   usage_period_us=10_000_000)
    stack = os.path.join(d, "stack.npz")
    precompile_trace(CFG, d, stack, 30, start_us=START, shard_windows=10)
    specs = expand_grid(scheduler=list(schedulers),
                        node_outage_frac=[0.0, 0.25])
    kw = dict(batch_windows=10, device="cpu")

    fleet_a = ScenarioFleet.from_precompiled(CFG, stack, specs, **kw)
    fleet_a.run()
    fleet_b1 = ScenarioFleet.from_precompiled(CFG, stack, specs,
                                              n_windows=10, **kw)
    fleet_b1.run()
    snap = os.path.join(d, "fleet.npz")
    fleet_b1.save(snap)
    fleet_b2 = ScenarioFleet.from_precompiled(CFG, stack, specs,
                                              start_window=10, **kw)
    fleet_b2.restore(snap)
    assert fleet_b2.windows_done == 10
    fleet_b2.run()
    assert fleet_b2.windows_done == 30
    for f in SimState._fields:
        assert torch.equal(getattr(fleet_a.state, f),
                           getattr(fleet_b2.state, f)), f
    frame_a, frame_b = fleet_a.stats_frame(), fleet_b2.stats_frame()
    for k in frame_a:
        assert np.array_equal(frame_a[k][10:], frame_b[k]), k
    assert [s["name"] for s in load_snapshot(snap, device="cpu")
            .extra["specs"]] == [s.name for s in specs]
    with pytest.raises(ValueError, match="scenarios"):
        ScenarioFleet(CFG, iter(()), specs[:1], **kw).restore(snap)
