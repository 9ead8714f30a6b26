"""``scenarios.batch.make_scenario_step`` of the port against the
reference's, on the CPU: the inputs of the two reference tests that call it
(``tests/test_scenarios.py`` — outage nodes never activate;
``tests/test_sched_registry.py`` — a registered plugin dispatches in the
step), every state field exact and every stats column bitwise (the two
balance variances within rtol 5e-7, the port's f64 sums; ROADMAP Queue 3).
The registry test's payloads are off the 1/128 grid, so there the float
columns, sums over nodes in another order, hold within rtol 2.5e-7 (2
ulp), ROADMAP's parity bar for such inputs. And a one-lane step equals one
window of ``run_scenarios``.

The port's step is lane-batched: a one-lane state stands for the
reference's unbatched one, and a B-lane state for its vmapped step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import REDUCED_SIM as REF_CFG
from repro.core.events import pack_window as ref_pack_window
from repro.core.state import init_state as ref_init_state
from repro.scenarios import ScenarioSpec as RefSpec
from repro.scenarios import batch as ref_batch
from repro.scenarios import build_knobs as ref_build_knobs
from repro.sched import register_scheduler as ref_register
from repro.sched import unregister_scheduler as ref_unregister
from repro_torch.config import REDUCED_SIM as CFG
from repro_torch.core import engine as eng
from repro_torch.core import prng
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import lane, state_to_numpy, validate_invariants
from repro_torch.scenarios import ScenarioSpec, build_knobs
from repro_torch.scenarios import batch as batch_mod
from repro_torch.scenarios import perturb
from repro_torch.sched import register_scheduler, unregister_scheduler

torch.set_num_threads(1)

VARS = ("util_balance_var", "reserved_balance_var")
VAR_RTOL = 5e-7
OFF_GRID_RTOL = 2.5e-7


def _assert_rows(got, want, off_grid=False):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in VARS:
            np.testing.assert_allclose(g, w, rtol=VAR_RTOL, atol=0, err_msg=k)
        elif off_grid and g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=OFF_GRID_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_state(got, want):
    got = state_to_numpy(got)
    for k, w in want._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


def _windows(cfg, ref=False):
    """Node ADDs for every slot, as the reference's outage test packs."""
    evs = [HostEvent(i, EventKind.ADD_NODE, i, a=(1.0, 1.0, 1.0))
           for i in range(cfg.max_nodes)]
    if ref:
        return jax.tree.map(jnp.asarray, ref_pack_window(cfg, evs, 0))
    return window_to_torch(pack_window(cfg, evs, 0), "cpu")


def test_outage_nodes_never_activate_end_to_end():
    """tests/test_scenarios.py:69-80 on both packages: the hashed outage
    nodes never activate, and the one-lane step is the reference's."""
    knobs, names = build_knobs([ScenarioSpec(node_outage_frac=0.4)])
    rknobs, rnames = ref_build_knobs([RefSpec(node_outage_frac=0.4)])
    step = batch_mod.make_scenario_step(CFG, names)
    state, stats = step(batch_mod.init_batched_state(CFG, 1, "cpu"),
                        _windows(CFG), prng.key(0, "cpu"), knobs)
    rstep = ref_batch.make_scenario_step(REF_CFG, rnames)
    rstate, rstats = rstep(ref_init_state(REF_CFG), _windows(REF_CFG, True),
                           jax.random.PRNGKey(0),
                           jax.tree.map(lambda a: a[0], rknobs))
    _assert_state(lane(state, 0), rstate)
    _assert_rows({k: v[0] for k, v in stats.items()}, rstats)
    active = state.node_active[0].numpy()
    expect_dead = perturb.hash01(
        torch.arange(CFG.max_nodes, dtype=torch.int32), perturb._SALT_OUTAGE,
        CFG).numpy() < 0.4
    assert expect_dead.any() and not active[expect_dead].any()
    assert active[~expect_dead].all()


def _propose_pack_left(state, cfg, rng, idx, valid, base_ok, scores):
    """Prefer the most-reserved node (consolidation / bin-packing)."""
    return state.node_reserved.sum(-1)[None, :].expand(base_ok.shape)


def _ref_propose_pack_left(state, cfg, rng, idx, valid, base_ok, scores):
    return jnp.broadcast_to(state.node_reserved.sum(-1)[None, :],
                            base_ok.shape)


@pytest.fixture
def pack_left():
    name = "_t_step_pack_left"
    register_scheduler(name, _propose_pack_left)
    ref_register(name, _ref_propose_pack_left)
    yield name
    unregister_scheduler(name)
    ref_unregister(name)


def _task_windows(cfg, packer, n_nodes=8, n_tasks=24, seed=0):
    r = np.random.default_rng(seed)
    evs0 = [HostEvent(0, EventKind.ADD_NODE, i,
                      a=(float(r.uniform(0.4, 1.0)),
                         float(r.uniform(0.4, 1.0)), 1.0))
            for i in range(n_nodes)]
    evs1 = [HostEvent(1, EventKind.ADD_TASK, t,
                      a=(float(r.uniform(0.02, 0.2)),
                         float(r.uniform(0.02, 0.2)), 0.0),
                      prio=int(r.integers(0, 12))) for t in range(n_tasks)]
    return stack_windows([packer(cfg, evs0, 0), packer(cfg, evs1, 1)])


def test_registered_scheduler_dispatches_in_scenario_step(pack_left):
    """tests/test_sched_registry.py:71-90 on both packages: a plugin named
    in a spec rides the step beside greedy, lane for lane the reference's
    vmapped step."""
    specs = [dict(name="greedy"), dict(name="plugin", scheduler=pack_left)]
    knobs, names = build_knobs([ScenarioSpec(**s) for s in specs])
    rknobs, rnames = ref_build_knobs([RefSpec(**s) for s in specs])
    assert names == rnames == ("greedy", pack_left)
    step = batch_mod.make_scenario_step(CFG, names)
    vstep = jax.vmap(ref_batch.make_scenario_step(REF_CFG, rnames),
                     in_axes=(0, None, None, 0))
    state = batch_mod.init_batched_state(CFG, 2, "cpu")
    rstate = ref_batch.init_batched_state(REF_CFG, 2)
    ws = window_to_torch(_task_windows(CFG, pack_window), "cpu")
    rws = jax.tree.map(jnp.asarray, _task_windows(REF_CFG, ref_pack_window))
    key, rkey = prng.key(0, "cpu"), jax.random.PRNGKey(0)
    for w in range(2):
        state, stats = step(state, eng.window_at(ws, w), key, knobs)
        rstate, rstats = vstep(rstate, jax.tree.map(lambda x: x[w], rws),
                               rkey, rknobs)
        _assert_state(state, rstate)
        _assert_rows(stats, rstats, off_grid=True)
    assert (stats["placements"] > 0).all()
    for b in range(2):
        assert validate_invariants(lane(state, b), CFG) == {}, specs[b]
    # consolidation really differs from best-fit-decreasing
    assert not torch.equal(state.task_node[0], state.task_node[1])


@pytest.mark.parametrize("scheduler", ["greedy", "first_fit"])
def test_one_lane_step_is_one_window_of_run_scenarios(scheduler):
    cfg = dataclasses.replace(CFG, inject_slots=16, inject_task_slots=64)
    spec = ScenarioSpec(scheduler=scheduler, arrival_rate=2.0,
                        evict_storm_frac=0.1)
    knobs, names = build_knobs([spec])
    ws = window_to_torch(_task_windows(cfg, pack_window), "cpu")
    step = batch_mod.make_scenario_step(cfg, names)
    keys = eng.window_keys(5, 2, "cpu")
    state = batch_mod.init_batched_state(cfg, 1, "cpu")
    rows = []
    for w in range(2):
        state, row = step(state, eng.window_at(ws, w), keys[w], knobs)
        rows.append(row)
    want, wrows = batch_mod.run_scenarios(
        batch_mod.init_batched_state(cfg, 1, "cpu"), ws, knobs, cfg, names,
        seed=5)
    for f in state._fields:
        assert torch.equal(getattr(state, f), getattr(want, f)), f
    for k, v in wrows.items():
        assert torch.equal(torch.stack([r[k] for r in rows]), v), k
    assert int(wrows["injected_arrivals"].sum()) > 0
