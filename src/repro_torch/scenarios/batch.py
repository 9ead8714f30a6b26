"""Batched what-if engine: B scenarios advanced together, lane-batched.

The fleet state is a ``SimState`` with a leading lane axis B on every field
(``init_batched_state``); the engine passes of ``core/engine.py`` already
take that form, so one window costs one set of launches for all lanes,
where the reference vmaps a single-scenario step. Per window:

* the shared window passes through :func:`perturb.perturb_window`, which
  returns each lane's window;
* events are applied, invalid placements evicted, then
  :func:`perturb.storm_evict` and :func:`perturb.expire_injected` run
  (:func:`make_scenario_prelude`);
* the scheduling pass dispatches every lane at once, by one of two paths
  that give bitwise the same lanes:

  - **switchless** (``cfg.sched_dispatch`` 'auto' or 'table', every lane's
    scheduler with a table form, a static lane assignment): one base pass
    and ONE fused commit (kernel D, ``sched.table.make_switchless_dispatch``);
  - **switch fallback** (an opaque plugin in the mix, or 'switch'): one base
    pass, each lane's proposal on its own views, then one commit launch with
    a per-lane dynamic flag (kernel B in mode 'both').

With identity knobs and the same scheduler, lane 0 computes bit-identically
to ``engine.run_windows``. :func:`make_scenario_step` is the one-window
step with its stats row, for unit tests and the stride-1 mental model.

``run_scenarios_sharded`` splits the lanes over the ranks of a 1-D
``('data',)`` ``DeviceMesh`` (:func:`fleet_mesh`; ``torch.distributed``,
one process a device, NCCL on the card and gloo on the CPU): each rank
holds and advances its contiguous block of B/n lanes
(:func:`shard_over_fleet`), every rank reads the same windows, and the
(W, B/n, ...) stats rows are gathered along the lane axis into (W, B, ...)
on every rank. The window keys are shared by every lane, so a lane's result
does not depend on its rank: sharding is a pure layout change, bitwise.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import SimConfig
from repro_torch.core import engine as eng
from repro_torch.core import stats as stats_mod
from repro_torch.core.events import EventKind, EventWindow
from repro_torch.core.state import SimState, init_state
from repro_torch.device import resolve_device
from repro_torch.kernels.placement_commit.ops import lane_const
from repro_torch.scenarios import perturb
from repro_torch.scenarios.spec import ScenarioKnobs
from repro_torch.sched import (DispatchTable, base_pass, finalize,
                               make_switchless_dispatch, propose_lanes,
                               snapshot_dispatch)


FLEET_AXIS = "data"   # the mesh axis the scenario lanes shard over


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _start_world(dev: torch.device):
    """The default process group of a fleet mesh: from the ``torchrun``
    environment when there is one, else a world of 1 over a FileStore in
    a temporary directory. On the card each rank takes ``cuda:LOCAL_RANK``
    and NCCL, on the CPU gloo."""
    import torch.distributed as dist
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
        return
    d = tempfile.mkdtemp(prefix="fleet_mesh.")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    dist.init_process_group(backend,
                            store=dist.FileStore(os.path.join(d, "store"), 1),
                            rank=0, world_size=1, **kw)


def fleet_mesh(n_devices: Optional[int] = None, device=None):
    """A 1-D ``('data',)`` ``DeviceMesh`` over the world's ranks.

    ``device`` is the fleet's device (the card unless "cpu" is passed): on
    the card the mesh is a "cuda" mesh over NCCL, one rank a card, each
    rank on ``cuda:LOCAL_RANK``; on the CPU it is a "cpu" mesh over gloo.
    Without a default process group one is started, from the ``torchrun``
    environment when there is one, else as a world of 1; the caller ends
    it with ``torch.distributed.destroy_process_group()``.

    The one difference from the reference's mesh over "the first
    ``n_devices``": the port runs one process a device, so ``n_devices``
    (default: the world size) must equal the world size.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    world = _world_size()
    n = world if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"fleet_mesh needs at least 1 device, got {n}")
    if n != world:
        raise ValueError(f"--mesh {n} != the {world} rank(s) of this world "
                         "(one process a device: launch with torchrun "
                         f"--nproc-per-node {n})")
    if not dist.is_initialized():
        _start_world(dev)
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(FLEET_AXIS,))


def lane_block(n_lanes: int, mesh) -> Tuple[int, int]:
    """This rank's contiguous lanes ``[r*B/n, (r+1)*B/n)`` of B =
    ``n_lanes`` (all of them without a mesh): the fleet's lane split."""
    if mesh is None:
        return 0, n_lanes
    n = mesh.size()
    if n_lanes % n:
        raise ValueError(f"B={n_lanes} lanes not divisible by the {n}-device "
                         f"'{FLEET_AXIS}' mesh axis — pad the spec list")
    per = n_lanes // n
    r = mesh.get_local_rank(FLEET_AXIS)
    return r * per, (r + 1) * per


def shard_over_fleet(tree, mesh):
    """This rank's block (:func:`lane_block`) of every leaf's leading
    (lane) axis: knobs, batched states and restored snapshots all go
    through here. No-op without a mesh. The block is a copy, so the full
    tensors can be freed.
    """
    if mesh is None:
        return tree
    lo, hi = lane_block(tree[0].shape[0], mesh)
    return type(tree)(*[x[lo:hi].clone() for x in tree])


def gather_over_fleet(tree, mesh, axis: int = 0):
    """Every rank's block of each leaf's lane axis ``axis``, concatenated
    in rank order on every rank (``all_gather`` over the mesh's group; each
    leaf keeps its dtype, and no value is reduced across ranks). A dict or
    a NamedTuple of tensors; no-op without a mesh."""
    if mesh is None:
        return tree
    import torch.distributed as dist
    group = mesh.get_group(FLEET_AXIS)
    n = mesh.size()

    def gather(x):
        local = x.movedim(axis, 0).contiguous()
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts).movedim(0, axis)

    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return type(tree)(*[gather(x) for x in tree])


def init_batched_state(cfg: SimConfig, n_scenarios: int, device,
                       mesh=None) -> SimState:
    """A lane-batched SimState: ``n_scenarios`` identical empty worlds,
    each with its own storage (the engine updates tables in place). Under
    a ``mesh`` only this rank's block of B/n lanes is built, never all B.
    """
    lo, hi = lane_block(n_scenarios, mesh)
    return SimState(*[x.unsqueeze(0).repeat((hi - lo,) + (1,) * x.dim())
                      for x in init_state(cfg, device)])


def make_scenario_prelude(cfg: SimConfig, has_storm: bool = True):
    """The pre-dispatch transition of every lane: window perturbation,
    event application, eviction, storm, injection expiry. Returns
    ``prelude(state_B, w, knobs) -> (state_B, injected (B,) i32)`` for one
    shared window ``w`` (E, ...)."""

    def prelude(state: SimState, w: EventWindow, knobs: ScenarioKnobs
                ) -> Tuple[SimState, torch.Tensor]:
        w = perturb.perturb_window(w, knobs, cfg, window=state.window)
        if cfg.inject_slots:
            injected = (w.kind[:, -cfg.inject_slots:] == EventKind.ADD_TASK
                        ).sum(-1, dtype=torch.int32)
        else:
            injected = torch.zeros_like(state.window)
        state = eng.apply_node_events(state, w, cfg)
        state = eng.apply_task_events(state, w, cfg)
        if not cfg.incremental_accounting:
            state = eng.recompute_accounting(state, cfg)
        state = eng.evict_invalid(state, cfg)
        if has_storm:
            state = perturb.storm_evict(state, knobs, cfg)
        if cfg.inject_slots:
            state = perturb.expire_injected(state, knobs, cfg)
        if not cfg.incremental_accounting:
            state = eng.recompute_accounting(state, cfg)
        return state, injected

    return prelude


def make_switch_dispatch(cfg: SimConfig, table: DispatchTable,
                         lane_scheds: Tuple[int, ...]):
    """The fallback scheduling pass: one base pass for all lanes, lane b's
    proposal ``table.proposers[lane_scheds[b]]`` on its own views, then one
    commit with a per-lane dynamic flag (the static flag when the table has
    one scheduler). Returns ``dispatch(state_B, rng=None) -> state_B``."""
    proposers = [table.proposers[s] for s in lane_scheds]
    flags = tuple(int(table.dynamic[s]) for s in lane_scheds)

    def dispatch(state: SimState, rng=None) -> SimState:
        idx, valid, base_ok, scores = base_pass(state, cfg)
        pref = propose_lanes(proposers, state, cfg, rng, idx, valid, base_ok,
                             scores)
        if len(table.names) == 1:
            dyn = bool(table.dynamic[0])
        else:
            dyn = lane_const(flags, state.window.device) != 0
        return finalize(state, cfg, idx, valid, base_ok, pref,
                        dynamic_bestfit=dyn)

    return dispatch


def _want_switchless(cfg: SimConfig, table: DispatchTable,
                     lane_scheds) -> bool:
    """Resolve ``cfg.sched_dispatch`` against what this call can do:
    switchless needs the static per-lane assignment and a table form for
    every scheduler; 'auto' falls back to the switch path without them,
    'table' raises."""
    able = lane_scheds is not None and table.switchless
    if cfg.sched_dispatch == "switch":
        return False
    if cfg.sched_dispatch == "table" and not able:
        opaque = [n for n, f in zip(table.names, table.forms) if f is None]
        if opaque:
            raise ValueError(
                f"cfg.sched_dispatch='table' but schedulers {opaque} have "
                "no table form — register_scheduler(..., table_form=...) "
                "them or drop to 'auto'/'switch'")
        raise ValueError(
            "cfg.sched_dispatch='table' but no static lane assignment was "
            "provided — pass lane_scheds, or use 'auto' or 'switch'")
    return able


def make_scenario_advance(cfg: SimConfig, scheduler_names: Tuple[str, ...],
                          has_storm: bool = True,
                          table: Optional[DispatchTable] = None,
                          lane_scheds: Tuple[int, ...] = (),
                          switchless: bool = False):
    """The stats-free transition of every lane:
    ``advance(state_B, w, knobs, rng) -> (state_B, injected (B,) i32)``,
    ``rng`` the window's scheduler key, shared by every lane; the
    per-window injected count rides along so strided stats rows can sum
    it. ``lane_scheds`` is the static per-lane scheduler index into
    ``scheduler_names``; ``switchless`` picks the fused dispatch."""
    if table is None:
        table = snapshot_dispatch(scheduler_names)
    prelude = make_scenario_prelude(cfg, has_storm)
    make = make_switchless_dispatch if switchless else make_switch_dispatch
    dispatch = make(cfg, table, tuple(lane_scheds))

    def advance(state: SimState, w: EventWindow, knobs: ScenarioKnobs,
                rng=None) -> Tuple[SimState, torch.Tensor]:
        state, injected = prelude(state, w, knobs)
        state = dispatch(state, rng)
        if not cfg.incremental_accounting:
            state = eng.recompute_accounting(state, cfg)
        return state._replace(window=state.window + 1), injected

    return advance


def make_scenario_step(cfg: SimConfig, scheduler_names: Tuple[str, ...],
                       has_storm: bool = True,
                       table: Optional[DispatchTable] = None):
    """The one-window step of every lane, its stats row included:
    ``step(state_B, w, rng, knobs) -> (state_B, stats)`` with
    ``injected_arrivals`` in the stats, in the reference's argument order
    (``rng`` before ``knobs``). A one-lane state stands for the reference's
    unbatched one. Each call dispatches through the switch path on the
    lanes' schedulers read from ``knobs.sched_idx``, as the reference's
    ``lax.switch`` does; ``run_scenarios`` composes the advance and the
    stats itself, so strided runs skip the stats work."""
    if table is None:
        table = snapshot_dispatch(scheduler_names)

    def step(state: SimState, w: EventWindow, rng, knobs: ScenarioKnobs
             ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        advance = make_scenario_advance(cfg, scheduler_names, has_storm,
                                        table, tuple(knobs.sched_idx.tolist()))
        state, injected = advance(state, w, knobs, rng)
        stats = stats_mod.window_stats(state, cfg)
        stats["injected_arrivals"] = injected
        return state, stats

    return step


def run_scenarios(state: SimState, windows: EventWindow, knobs: ScenarioKnobs,
                  cfg: SimConfig, scheduler_names: Tuple[str, ...],
                  seed: int = 0, has_storm: bool = True,
                  table: Optional[DispatchTable] = None,
                  lane_scheds: Optional[Tuple[int, ...]] = None
                  ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """Advance the fleet over stacked windows.

    state: lane-batched SimState (updated in place, like ``run_windows``);
    windows: (W, ...) stacked EventWindow shared by every lane; knobs: (B,)
    ScenarioKnobs. Returns the advanced state and a stats dict of (W, B,
    ...) tensors, ``injected_arrivals`` included. ``has_storm=False`` drops
    the eviction-storm pass (valid only when every lane's storm_frac is 0).

    Dispatch: with ``lane_scheds`` (the fleet's static per-lane scheduler
    indices, which must agree with ``knobs.sched_idx``) and a fully
    table-formed snapshot, the switchless path; otherwise the switch
    fallback (which reads ``knobs.sched_idx`` once when ``lane_scheds`` is
    not given). The window keys are ``engine.window_keys(seed, W)``, as in
    ``engine.run_windows``, and every lane of a window gets its row (common
    random numbers, the reference's rule for paired what-if comparisons).

    With ``cfg.stats_stride == k > 1`` one (B, ...) row is emitted per k
    windows, the tail as one final partial row, ``injected_arrivals``
    summed over each chunk — the cadence of ``engine.run_windows``.
    """
    if table is None:
        table = snapshot_dispatch(scheduler_names)
    switchless = _want_switchless(cfg, table, lane_scheds)
    if lane_scheds is None:
        lane_scheds = tuple(knobs.sched_idx.tolist())
    advance = make_scenario_advance(cfg, scheduler_names, has_storm, table,
                                    lane_scheds, switchless)

    def rows_for(s, injected):
        rows = stats_mod.window_stats(s, cfg)
        rows["injected_arrivals"] = injected
        return rows

    W = windows.kind.shape[0]
    if W == 0:
        return state, {k: v[None][:0] for k, v in
                       rows_for(state, torch.zeros_like(state.window)).items()}
    keys = iter(eng.window_keys(seed, W, state.window.device))

    def chunk(s, ws):
        acc = torch.zeros_like(s.window)
        for j in range(ws.kind.shape[0]):
            s, injected = advance(s, eng.window_at(ws, j), knobs, next(keys))
            acc = acc + injected
        return s, rows_for(s, acc)

    return eng.scan_strided(chunk, state, windows, W, cfg.stats_stride)


def resync_fleet(state: SimState, cfg: SimConfig) -> SimState:
    """Per-lane full recompute of both accounting tallies — the fleet
    driver's periodic drift resync under incremental accounting (kernel E,
    one launch per tally for all lanes, every ``resync_windows``
    windows)."""
    return eng.recompute_accounting(state, cfg)


def run_scenarios_sharded(state: SimState, windows: EventWindow,
                          knobs: ScenarioKnobs, cfg: SimConfig,
                          scheduler_names: Tuple[str, ...], mesh,
                          seed: int = 0, has_storm: bool = True,
                          table: Optional[DispatchTable] = None,
                          lane_scheds: Optional[Tuple[int, ...]] = None
                          ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """``run_scenarios`` with the lanes split over the ranks of ``mesh``.

    ``state`` and ``knobs`` hold this rank's block of B/n lanes
    (:func:`shard_over_fleet`); ``windows`` are the same on every rank. The
    local lanes run ``run_scenarios`` with the same key schedule, and the
    (W, B/n, ...) stats rows are gathered along the lane axis into (W, B,
    ...) on every rank. Returns the advanced local state and the gathered
    stats. ``lane_scheds`` are the local lanes' static scheduler indices
    (read once from ``knobs.sched_idx`` when not given). B must divide by
    the mesh size: :func:`shard_over_fleet` and :func:`init_batched_state`
    raise otherwise, before any lane runs (``ScenarioFleet`` pads).

    Like the reference's sharded fleet, this always dispatches through the
    switch path (kernel B in mode 'both' over the local lanes);
    ``cfg.sched_dispatch='table'`` raises. Lane trajectories are bitwise
    those of the unsharded (switchless) fleet.
    """
    if cfg.sched_dispatch == "table":
        raise ValueError(
            "cfg.sched_dispatch='table' is incompatible with mesh-sharded "
            "fleets (the sharded fleet dispatches through the switch path, "
            "with no static per-lane grouping) — use 'auto'")
    state, stats = run_scenarios(
        state, windows, knobs, dataclasses.replace(cfg,
                                                   sched_dispatch="switch"),
        scheduler_names, seed, has_storm, table, lane_scheds)
    return state, gather_over_fleet(stats, mesh, axis=1)
