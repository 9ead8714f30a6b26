"""The paper's 12,500-node cell on the port, on the CPU: the counterpart of
``tests/test_full_cell.py`` at ``configs/agocs_full_cell`` widths (N =
12,500, 262,144 task slots, E = 8,192), each check held against the JAX
package's plain path (``use_kernels=False``):

* the node ADDs streamed over two windows, because 12,500 > E, then a task
  wave and a 2,000-node removal: ``evict_invalid`` and the node-dimension
  stats at full width, invariants clean;
* the port's plain commit at N = 12,500 against the reference's untiled
  commit and its tiled kernel (``commit_tile_n`` 8,192, interpret mode),
  one operand set and the engine end to end;
* a switchless two-lane fleet (greedy and round_robin) at full width.

Decisions, integer state and counters exact; float state bitwise. The
payloads are the reference test's, drawn off the 1/128 grid, so the float
stats columns (sums over 12,500 nodes or 262,144 tasks, in another order)
hold within rtol 2.5e-7 (2 ulp), ROADMAP's parity bar for such inputs. The
balance variances: the port sums in f64 and rounds once (ROADMAP Queue 3),
so its final row is held within 2.5e-7 of an f64 recomputation from the
final state; the reference sums 12,500 f32 terms, whose rounding error is
bounded by ceil(log2 N) units of 2^-24 (8.3e-7 at N = 12,500), and the two
packages agree within that. ``slow``, as the reference's suite is; the
scheduling batch is the reference's smoke size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.agocs_full_cell import CONFIG as REF_FULL
from repro.core import engine as ref_eng
from repro.core.events import pack_window as ref_pack_window
from repro.core.events import stack_windows as ref_stack_windows
from repro.core.state import init_state as ref_init_state
from repro.kernels.placement_commit.ops import sched_pass as ref_sched_pass
from repro.scenarios import ScenarioSpec as RefSpec
from repro.scenarios import batch as ref_batch
from repro.scenarios import build_knobs as ref_build_knobs
from repro.sched import snapshot_dispatch as ref_snapshot
from repro_torch.configs.agocs_full_cell import CONFIG as FULL_CELL
from repro_torch.core import engine as eng
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import (init_state, lane, state_to_numpy,
                                    validate_invariants)
from repro_torch.kernels.placement_commit.ops import (placement_commit,
                                                      sched_pass)
from repro_torch.scenarios import ScenarioSpec, build_knobs
from repro_torch.scenarios import batch as batch_mod
from repro_torch.sched import get_scheduler, snapshot_dispatch

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

N_FULL = FULL_CELL.max_nodes                 # 12,500
E = FULL_CELL.max_events_per_window          # 8,192 < N_FULL
VARS = ("util_balance_var", "reserved_balance_var")
RTOL = 2.5e-7
# the reference's f32 sum of N_FULL terms: ceil(log2 N) roundings of 2^-24
VAR_RTOL = float(np.ceil(np.log2(N_FULL))) * 2.0 ** -24


def _over(**over):
    base = dict(sched_batch=16, buffer_windows=4, buffer_max_events=65_536)
    base.update(over)
    return base


def _cfgs(**over):
    o = _over(**over)
    return (dataclasses.replace(FULL_CELL, **o),
            dataclasses.replace(REF_FULL, **o))


def _events(n_tasks=1_024, seed=0):
    """The reference test's 4 windows: the 12.5K-node fleet split over two
    ADD windows (the cap forces it), a task wave, then node removals that
    strand placed tasks."""
    r = np.random.default_rng(seed)

    def node(i):
        return HostEvent(0, EventKind.ADD_NODE, i,
                         a=(float(r.uniform(0.4, 1.0)),
                            float(r.uniform(0.4, 1.0)), 1.0))

    assert N_FULL > E, "full cell must overflow one window's event budget"
    w0 = [node(i) for i in range(E)]
    w1 = [node(i) for i in range(E, N_FULL)]
    w2 = [HostEvent(2, EventKind.ADD_TASK, t,
                    a=(float(r.uniform(0.002, 0.02)),
                       float(r.uniform(0.002, 0.02)), 0.0),
                    prio=int(r.integers(0, 12)))
          for t in range(n_tasks)]
    w3 = [HostEvent(3, EventKind.REMOVE_NODE, i) for i in range(0, 2_000)]
    return [w0, w1, w2, w3]


def _windows(cfg, ref_cfg):
    evs = _events()
    port = window_to_torch(stack_windows(
        [pack_window(cfg, e, i) for i, e in enumerate(evs)]), "cpu")
    ref = jax.tree.map(jnp.asarray, ref_stack_windows(
        [ref_pack_window(ref_cfg, e, i) for i, e in enumerate(evs)]))
    return port, ref


def _assert_rows(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in VARS:
            np.testing.assert_allclose(g, w, rtol=VAR_RTOL, atol=0, err_msg=k)
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_variances_near_exact(state, rows):
    """The last row's variances within RTOL of f64 sums of the per-node
    values the stats take (the mean rounded to f32 first, as both packages
    do); ``state`` and ``rows`` lane-batched."""
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


def _assert_state(got, want):
    got = state_to_numpy(got)
    for k, w in want._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


def _ref_run(ref_cfg, ref_ws):
    return ref_eng.run_windows_jit(ref_init_state(ref_cfg), ref_ws, ref_cfg,
                                   "greedy", 0)


def test_full_cell_engine_paths_at_n12500():
    """Streamed node ADDs, placements, node-dim stats, evict_invalid after
    a 2,000-node removal, at paper width, against the reference's plain
    engine."""
    cfg, ref_cfg = _cfgs(sched_batch=256)
    ws, ref_ws = _windows(cfg, ref_cfg)
    # the fleet is streamed: neither ADD window holds all 12,500 nodes
    kinds = ws.kind.numpy()
    adds = (kinds == EventKind.ADD_NODE).sum(-1)
    assert adds[0] == E and adds[1] == N_FULL - E
    state, stats = eng.run_windows(init_state(cfg, "cpu"), ws, cfg,
                                   get_scheduler("greedy"), 0)
    rstate, rstats = _ref_run(ref_cfg, ref_ws)
    _assert_state(state, rstate)
    _assert_rows(stats, rstats)
    _assert_variances_near_exact(
        type(state)(*[x[None] for x in state]),
        {k: stats[k][:, None] for k in VARS})
    assert int(state.node_active.sum()) == N_FULL - 2_000
    assert int(stats["n_nodes"][1]) == N_FULL
    assert int(stats["placements"][-1]) > 0
    assert int(stats["evictions"][-1]) > 0          # stranded by REMOVE_NODE
    assert validate_invariants(state, cfg) == {}


def test_full_cell_plain_commit_matches_tiled_and_untiled():
    """The port's plain commit at N=12,500: the engine end to end against
    the reference's untiled commit and its tiled kernel (commit_tile_n
    8,192), not one placement moved."""
    cfg, _ = _cfgs()
    ws, ref_ws = _windows(cfg, dataclasses.replace(REF_FULL, **_over()))
    state, stats = eng.run_windows(init_state(cfg, "cpu"), ws, cfg,
                                   get_scheduler("greedy"), 0)
    assert int(stats["placements"][-1]) > 0
    for over in (dict(), dict(use_kernels=True, commit_tile_n=8_192)):
        ref_cfg = dataclasses.replace(REF_FULL, **_over(**over))
        rstate, rstats = _ref_run(ref_cfg, ref_ws)
        _assert_state(state, rstate)
        _assert_rows(stats, rstats)


def test_full_cell_sched_pass_streams_node_tiles():
    """ops level, the reference test's operands: the port's plain commit
    and its fused sched_pass at N=12,500 against the reference's whole-N
    commit and its streaming kernel (2 x 8,192 tiles), bitwise."""
    P, N, R = 16, N_FULL, 3
    r = np.random.default_rng(7)
    scores = r.normal(size=(P, N)).astype(np.float32)
    req = (r.integers(1, 8, size=(P, R)) / 256.0).astype(np.float32)
    ok = r.random(size=(P, N)) < 0.7
    valid = np.ones((P,), bool)
    total = (r.integers(64, 256, size=(N, R)) / 64.0).astype(np.float32)
    denom = np.maximum(total, 1e-6)
    res0 = np.zeros((N, R), np.float32)
    args = (scores, req, ok, valid, total, denom, res0)
    j = [jnp.asarray(a) for a in args]
    t = [torch.from_numpy(a) for a in args]
    want = [ref_sched_pass(*j, use_kernel=False, return_tally=True),
            ref_sched_pass(*j, use_kernel=True, interpret=True, tile_n=8_192,
                           return_tally=True)]
    got = [placement_commit(*t, False, return_tally=True),
           sched_pass(*t, return_tally=True)]
    for g in got:
        for w in want:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((got[0][0] >= 0).sum()) > 0


def test_full_cell_switchless_fleet_smoke():
    """Two-lane switchless fleet (greedy + round_robin) at paper width,
    lane for lane the reference's."""
    cfg, ref_cfg = _cfgs(sched_batch=128, sched_dispatch="table")
    ws, ref_ws = _windows(cfg, ref_cfg)
    specs = [dict(name="g"), dict(name="rr", scheduler="round_robin")]
    knobs, names = build_knobs([ScenarioSpec(**s) for s in specs])
    rknobs, rnames = ref_build_knobs([RefSpec(**s) for s in specs])
    lane_scheds = tuple(names.index(s["scheduler"]) if "scheduler" in s
                        else 0 for s in specs)
    state, stats = batch_mod.run_scenarios(
        batch_mod.init_batched_state(cfg, 2, "cpu"), ws, knobs, cfg, names,
        0, False, snapshot_dispatch(names), lane_scheds)
    rstate, rstats = ref_batch.run_scenarios(
        ref_batch.init_batched_state(ref_cfg, 2), ref_ws, rknobs, ref_cfg,
        rnames, 0, False, ref_snapshot(rnames), lane_scheds)
    _assert_state(state, rstate)
    _assert_rows(stats, rstats)
    _assert_variances_near_exact(state, stats)
    assert (stats["placements"][-1] > 0).all()
    for b in range(2):
        assert validate_invariants(lane(state, b), cfg) == {}, specs[b]
