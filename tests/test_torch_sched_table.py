"""The proposal table and the fused scheduler pass of the port against the
reference's, on the CPU.

* ``sched_pref_ref`` for every family, and the plain ``sched_commit_fleet``
  and ``sched_pass`` against the reference's ``sched_commit_fleet`` /
  ``sched_pass`` run as its Pallas kernel in interpret mode, with the node
  dim whole and streamed in tiles (the streamed kernel must give the same
  answer): mixed families (scores, node order, external rows), per-lane
  modes static / dynamic / both, a lane-shared (size-1) operand, odd
  shapes. node_of exact, the tally bitwise (grid-aligned data).
* The commit scan's per-lane flag ('both') against the reference's
  ``placement_commit`` vmapped with a traced flag.
* The built-in table forms equal their proposals; a runtime table-form
  plugin rides the switchless path bitwise-equal to the switch path; an
  opaque plugin falls back (and 'table' refuses it); 'switch' is honoured;
  the dispatch table is frozen at fleet build.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.placement_commit import ops as ref_ops
from repro.kernels.placement_commit.ref import sched_pref_ref as ref_pref
from repro_torch.config import REDUCED_SIM
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import init_state, lift
from repro_torch.kernels.placement_commit import (FAM_EXTERNAL,
                                                  FAM_NODE_ORDER, FAM_SCORES)
from repro_torch.kernels.placement_commit import ops as pc_ops
from repro_torch.kernels.placement_commit.ref import sched_pref_ref
from repro_torch.scenarios import ScenarioFleet, ScenarioSpec, build_knobs
from repro_torch.scenarios import batch as batch_mod
from repro_torch.sched import (TableForm, base_pass, context_from_state,
                               get_entry, register_scheduler,
                               snapshot_dispatch, unregister_scheduler)

torch.set_num_threads(1)

CFG = dataclasses.replace(REDUCED_SIM, inject_slots=16, inject_task_slots=64)


def _operands(B, P, N, R=3, seed=0):
    """Grid-aligned lane operands (numpy): scores, ok, req, valid, total
    (dead nodes at -1), denom, reserved0."""
    r = np.random.default_rng(seed)
    g = lambda lo, hi, shape: (r.integers(lo, hi, shape) / 128).astype(
        np.float32)
    total = g(16, 256, (B, N, R))
    active = r.random((B, N)) > 0.15
    ok = r.random((B, P, N)) < 0.75
    scores = np.where(ok, g(-512, 0, (B, P, N)), -np.inf).astype(np.float32)
    scores[:, 1, ::3] = scores[:, 1, :1]         # ties inside a row
    ok[:, 2] = False                             # an all-infeasible row
    return (scores, ok, g(1, 64, (B, P, R)), r.random((B, P)) < 0.9,
            np.where(active[..., None], total, -1.0).astype(np.float32),
            np.maximum(total, 1e-6).astype(np.float32), g(0, 96, (B, N, R)))


LANES = {      # fam, dynamic per lane
    "static": ((FAM_SCORES, FAM_NODE_ORDER, FAM_EXTERNAL, FAM_NODE_ORDER),
               (False,) * 4),
    "dynamic": ((FAM_SCORES, FAM_NODE_ORDER, FAM_EXTERNAL, FAM_SCORES),
                (True,) * 4),
    "both": ((FAM_SCORES, FAM_NODE_ORDER, FAM_EXTERNAL, FAM_EXTERNAL),
             (True, False, False, True)),
}


@pytest.mark.parametrize("mode", list(LANES))
@pytest.mark.parametrize("P,N", [(13, 37), (24, 64)])
def test_sched_commit_fleet_matches_reference_kernel(mode, P, N):
    fam, dyn = LANES[mode]
    B = len(fam)
    scores, ok, req, valid, total, denom, res0 = _operands(B, P, N,
                                                           seed=P + N)
    r = np.random.default_rng(1)
    ext = (r.integers(-64, 64, (2, P, N)) / 128).astype(np.float32)
    ext_row = tuple(1 if (f == FAM_EXTERNAL and b == 3) else 0
                    for b, f in enumerate(fam))
    start = np.array([0, 7, 3, N - 1], np.int32)
    # the lanes share one request matrix (a size-1 lane operand)
    req = req[:1]
    got = pc_ops.sched_commit_fleet(
        *[torch.from_numpy(x) for x in (scores, ok, req, valid, total, denom,
                                        res0)],
        torch.from_numpy(start), fam=fam, dynamic=dyn,
        ext=torch.from_numpy(ext), ext_row=ext_row)
    for tile_n in (None, 8):
        want = ref_ops.sched_commit_fleet(
            jnp.asarray(scores), jnp.asarray(ok),
            jnp.asarray(np.broadcast_to(req, (B, P, 3))), jnp.asarray(valid),
            jnp.asarray(total), jnp.asarray(denom), jnp.asarray(res0),
            jnp.asarray(start), fam=fam, dynamic=dyn, ext=jnp.asarray(ext),
            ext_row=ext_row, interpret=True, tile_n=tile_n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{mode} tile_n={tile_n}")
    node_of = got[0].numpy()
    assert (node_of >= 0).any() and (node_of[:, 2] == -1).all()


@pytest.mark.parametrize("family,start", [(FAM_SCORES, 0),
                                          (FAM_NODE_ORDER, 0),
                                          (FAM_NODE_ORDER, 11)])
@pytest.mark.parametrize("dyn", [False, True])
def test_sched_pass_and_pref_match_reference(family, start, dyn):
    scores, ok, req, valid, total, denom, res0 = [
        x[0] for x in _operands(1, 21, 19, seed=start + 3)]
    pref = sched_pref_ref(torch.from_numpy(scores), start, family)
    np.testing.assert_array_equal(
        pref.numpy(), np.asarray(ref_pref(jnp.asarray(scores), start,
                                          family)))
    got = pc_ops.sched_pass(
        *[torch.from_numpy(x) for x in (scores, req, ok, valid, total, denom,
                                        res0)], dyn, family=family,
        start=start, return_tally=True)
    want = ref_ops.sched_pass(
        *[jnp.asarray(x) for x in (scores, req, ok, valid, total, denom,
                                   res0)], dyn, family=family, start=start,
        use_kernel=True, interpret=True, tile_n=8, return_tally=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sched_pref_external_needs_ext():
    with pytest.raises(ValueError, match="ext"):
        sched_pref_ref(torch.zeros(2, 3), 0, FAM_EXTERNAL)
    args = [torch.from_numpy(x) for x in _operands(2, 3, 4)]
    with pytest.raises(ValueError, match="ext"):
        pc_ops.sched_commit_fleet(*args, torch.zeros(2, dtype=torch.int32),
                                  fam=(FAM_SCORES, FAM_EXTERNAL),
                                  dynamic=(False, False))


def test_per_lane_flag_commit_matches_reference():
    """Mode 'both': the plain scan with a (B,) flag against the reference's
    placement_commit vmapped over a traced flag."""
    scores, ok, req, valid, total, denom, res0 = _operands(3, 17, 23, seed=4)
    flags = np.array([True, False, True])
    got = pc_ops.placement_commit(
        *[torch.from_numpy(x) for x in (scores, req, ok, valid, total, denom,
                                        res0)], torch.from_numpy(flags),
        return_tally=True)
    want = jax.vmap(lambda *a: ref_ops.placement_commit(
        *a[:7], a[7], return_tally=True))(
            *[jnp.asarray(x) for x in (scores, req, ok, valid, total, denom,
                                       res0, flags)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _soup_windows(seed=0, n_windows=6):
    r = np.random.default_rng(seed)
    g = lambda lo, hi: float(r.integers(lo, hi)) / 128
    wins = [[HostEvent(0, EventKind.ADD_NODE, m,
                       a=(g(64, 200), g(64, 200), g(64, 200)))
             for m in range(12)]]
    t = 0
    for _ in range(n_windows - 1):
        evs = []
        for _ in range(24):
            evs.append(HostEvent(1, EventKind.ADD_TASK, t,
                                 a=(g(2, 30), g(2, 30), g(0, 8)),
                                 prio=int(r.integers(0, 12))))
            t += 1
        wins.append(evs)
    return window_to_torch(stack_windows(
        [pack_window(CFG, e, i) for i, e in enumerate(wins)]), "cpu")


def test_builtin_table_forms_equal_their_proposals():
    state = lift(init_state(CFG, "cpu"))
    ws = _soup_windows()
    from repro_torch.core import engine
    advance = engine.make_window_advance(CFG, get_entry("greedy").entry)
    for j in range(3):
        state = advance(state, lift(engine.window_at(ws, j)))
    one = type(state)(*[x[0] for x in state])
    idx, valid, base_ok, scores = base_pass(one, CFG)
    ctx = context_from_state(one, idx, valid, base_ok, scores)
    for name in ("greedy", "first_fit", "round_robin"):
        e = get_entry(name)
        want = e.propose(one, CFG, None, idx, valid, base_ok, scores)
        got = e.table_form.transform(CFG, ctx, None, e.table_form.params)
        assert torch.equal(got, want), name


def _tf_pack_left(cfg, ctx, rng, params):
    return ctx.node_reserved.sum(-1)[None, :].expand(ctx.base_ok.shape)


def _propose_pack_left(state, cfg, rng, idx, valid, base_ok, scores):
    ctx = context_from_state(state, idx, valid, base_ok, scores)
    return _tf_pack_left(cfg, ctx, rng, ())


def _propose_pack_right(state, cfg, rng, idx, valid, base_ok, scores):
    return (-state.node_reserved.sum(-1))[None, :].expand(base_ok.shape)


@pytest.fixture
def table_plugin():
    name = "_t_pack_left"
    register_scheduler(name, _propose_pack_left,
                       table_form=TableForm(_tf_pack_left))
    yield name
    unregister_scheduler(name)


@pytest.fixture
def opaque_plugin():
    name = "_t_opaque"
    register_scheduler(name, _propose_pack_left)
    yield name
    unregister_scheduler(name)


def _run(cfg, specs, lane_scheds=True):
    knobs, names = build_knobs(specs)
    ls = (tuple(names.index(s.scheduler) for s in specs) if lane_scheds
          else None)
    return batch_mod.run_scenarios(
        batch_mod.init_batched_state(cfg, len(specs), "cpu"),
        _soup_windows(), knobs, cfg, names, 0,
        any(s.evict_storm_frac > 0 for s in specs), snapshot_dispatch(names),
        ls)


def _equal_states(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_table_form_plugin_rides_switchless(table_plugin):
    specs = [ScenarioSpec(name="g"),
             ScenarioSpec(name="p", scheduler=table_plugin),
             ScenarioSpec(name="rr", scheduler="round_robin"),
             ScenarioSpec(name="p2", scheduler=table_plugin,
                          evict_storm_frac=0.25)]
    _, names = build_knobs(specs)
    assert snapshot_dispatch(names).switchless
    table, _ = _run(CFG, specs)
    switch, _ = _run(dataclasses.replace(CFG, sched_dispatch="switch"),
                     specs)
    _equal_states(table, switch)
    # consolidation genuinely differs from greedy best-fit-decreasing
    assert not torch.equal(table.task_node[0], table.task_node[1])


def test_opaque_plugin_falls_back_to_switch(opaque_plugin):
    specs = [ScenarioSpec(name="g"),
             ScenarioSpec(name="p", scheduler=opaque_plugin)]
    _, names = build_knobs(specs)
    assert not snapshot_dispatch(names).switchless
    auto, _ = _run(CFG, specs)
    assert int(auto.placements.sum()) > 0
    strict = dataclasses.replace(CFG, sched_dispatch="table")
    with pytest.raises(ValueError, match=opaque_plugin):
        _run(strict, specs)
    with pytest.raises(ValueError, match="lane"):
        _run(strict, [ScenarioSpec(name="g")], lane_scheds=False)


def test_fleet_dispatch_frozen_at_construction(table_plugin):
    specs = [ScenarioSpec(name="g"),
             ScenarioSpec(name="p", scheduler=table_plugin)]
    ws = _soup_windows()

    def mk():
        src = (type(ws)(*[f[j].numpy() for f in ws]) for j in range(6))
        return ScenarioFleet(CFG, src, specs, batch_windows=3, device="cpu")

    control = mk()
    control.run()
    fleet = mk()
    frozen = fleet.dispatch_table
    register_scheduler(table_plugin, _propose_pack_right,
                       table_form=TableForm(_tf_pack_left), overwrite=True)
    try:
        assert frozen.proposers[1] is _propose_pack_left
        assert snapshot_dispatch(frozen.names).proposers[1] \
            is _propose_pack_right
        fleet.run()
        _equal_states(fleet.state, control.state)
    finally:
        register_scheduler(table_plugin, _propose_pack_left,
                           table_form=TableForm(_tf_pack_left),
                           overwrite=True)
