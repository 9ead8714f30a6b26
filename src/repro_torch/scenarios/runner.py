"""ScenarioFleet — one parsed trace feeding B divergent simulations.

Shares ``core.pipeline.WindowedDriver``'s drive loop (the same
WindowPrefetcher, pacing, resync phase and per-batch seed derivation as the
single-trajectory Simulation — lane 0's bit identity with it depends on
that), but advances a lane-batched SimState: the host parses and stages
each window batch once and every scenario consumes it.

Headless sweeps can decimate the stats stream (``cfg.stats_stride == k``):
the fleet emits one (B, ...) row per k windows, per-window injected counts
summed across each chunk; ``stats_window_indices()`` maps each row back to
its window. Mean columns of the report then average the decimated sample,
so compare sweeps at equal strides.

A fleet can be fed straight from a pre-compiled npz (:meth:`from_precompiled`,
``core/precompile.py``: zero parsing) and paused, saved and restored
mid-trace (:meth:`save` / ``restore``, ``core/snapshot.py``; the
resumed run is bitwise the uninterrupted one).

``mesh=`` (``batch.fleet_mesh``) splits the lanes over the ranks of a 1-D
``('data',)`` mesh, one process a device: each rank advances its block of
lanes, every rank reads the same windows (a pre-compiled stack makes that
a zero-parse read), and the stats rows are gathered, so ``stats_frame()``
and ``report()`` are equal on every rank. The spec list is padded up to a
multiple of the mesh size with identity lanes of the first spec's
scheduler; padding lanes are invisible in stats, reports and snapshots,
and snapshots are mesh-portable.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import torch

from repro_torch.config import SimConfig
from repro_torch.core.events import EventWindow
from repro_torch.core.pipeline import WindowedDriver
from repro_torch.core.snapshot import save_snapshot
from repro_torch.core.state import SimState
from repro_torch.scenarios import batch as batch_mod
from repro_torch.scenarios.report import scenario_report
from repro_torch.scenarios.spec import ScenarioSpec, build_knobs
from repro_torch.sched import snapshot_dispatch


class ScenarioFleet(WindowedDriver):
    """End-to-end batched what-if driver, on the card unless
    ``device="cpu"`` is passed.

    >>> specs = expand_grid(scheduler=["greedy", "first_fit"],
    ...                     node_outage_frac=[0.0, 0.2])
    >>> fleet = ScenarioFleet(cfg, parser.packed_windows(200), specs,
    ...                       mesh=batch.fleet_mesh())   # mesh is optional
    >>> fleet.run()
    >>> print(format_table(fleet.report()))
    """

    def __init__(self, cfg: SimConfig, window_source: Iterator[EventWindow],
                 specs: Sequence[ScenarioSpec], batch_windows: int = 32,
                 seed: Optional[int] = None, mesh=None, device=None):
        self.specs = list(specs)
        if not cfg.inject_slots:
            amped = [s.name for s in self.specs if s.arrival_rate > 1.0]
            if amped:
                raise ValueError(
                    f"scenarios {amped} have arrival_rate > 1 but "
                    "cfg.inject_slots == 0: amplification synthesises SUBMIT "
                    "events into the reserved slot pool, so the windows must "
                    "be packed with inject_slots > 0")
        super().__init__(cfg, window_source, batch_windows, seed, device)
        self.mesh = mesh
        lanes = list(self.specs)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type!r} mesh cannot carry "
                                 f"a fleet on {self.device}")
            n_dev = mesh.size()
            # pad to a lane count the mesh divides; padding lanes reuse the
            # first spec's scheduler so the dispatch table doesn't grow
            for i in range((-len(lanes)) % n_dev):
                lanes.append(ScenarioSpec(name=f"_pad{i}",
                                          scheduler=lanes[0].scheduler))
        self._lane_specs = lanes
        # storm-free fleets drop the eviction-storm pass entirely
        self._has_storm = any(s.evict_storm_frac > 0.0 for s in lanes)
        knobs, self.scheduler_names = build_knobs(lanes, self.device)
        # the dispatch contract, frozen now: plugins registered after
        # construction cannot retarget this fleet's scheduler indices
        self.dispatch_table = snapshot_dispatch(self.scheduler_names)
        scheds = tuple(self.scheduler_names.index(s.scheduler)
                       for s in lanes)
        # the static per-lane map enables switchless dispatch on the
        # unsharded path; the sharded path is the switch path, over this
        # rank's lanes
        self._lane_scheds = None if mesh is not None else scheds
        lo, hi = batch_mod.lane_block(len(lanes), mesh)
        self._local_scheds = scheds[lo:hi]
        self.knobs = batch_mod.shard_over_fleet(knobs, mesh)
        self.state = batch_mod.init_batched_state(cfg, len(lanes),
                                                  self.device, mesh)

    @classmethod
    def from_precompiled(cls, cfg: SimConfig, path: str,
                         specs: Sequence[ScenarioSpec],
                         batch_windows: int = 32, seed: Optional[int] = None,
                         mesh=None, n_windows: Optional[int] = None,
                         start_window: int = 0,
                         device=None) -> "ScenarioFleet":
        """A fleet fed straight from a pre-compiled npz (zero parsing).

        The npz must have been written by ``precompile_trace`` (of either
        package) under a shape-compatible config (same window geometry and
        slot-pool reservation) — validated against the npz's embedded
        metadata. ``n_windows`` truncates the replay; ``start_window`` skips
        into the stack (chunked stacks only decompress the covered range) —
        pair it with :meth:`restore` of a snapshot taken at that window to
        resume a fleet mid-trace.
        """
        from repro_torch.core.precompile import (replay_windows,
                                                 validate_replay)
        validate_replay(path, cfg)
        return cls(cfg,
                   replay_windows(path, batch=batch_windows,
                                  n_windows=n_windows,
                                  start_window=start_window),
                   specs, batch_windows=batch_windows, seed=seed, mesh=mesh,
                   device=device)

    @property
    def n_scenarios(self) -> int:
        return len(self.specs)

    @property
    def n_lanes(self) -> int:
        """Lane count: n_scenarios plus any mesh padding."""
        return len(self._lane_specs)

    @property
    def names(self) -> List[str]:
        return [s.name for s in self.specs]

    def _advance(self, batch: EventWindow, seed: int):
        if self.mesh is not None:
            self.state, stats = batch_mod.run_scenarios_sharded(
                self.state, batch, self.knobs, self.cfg,
                self.scheduler_names, self.mesh, seed,
                has_storm=self._has_storm, table=self.dispatch_table,
                lane_scheds=self._local_scheds)
        else:
            self.state, stats = batch_mod.run_scenarios(
                self.state, batch, self.knobs, self.cfg,
                self.scheduler_names, seed, has_storm=self._has_storm,
                table=self.dispatch_table, lane_scheds=self._lane_scheds)
        if self.n_lanes != self.n_scenarios:
            stats = {k: v[:, :self.n_scenarios] for k, v in stats.items()}
        return stats

    def _resync(self):
        return batch_mod.resync_fleet(self.state, self.cfg)

    def report(self, baseline: int = 0) -> dict:
        return scenario_report(self.names, self.stats_frame(),
                               [s.scheduler for s in self.specs],
                               baseline=baseline)

    # --- pause/snapshot/resume (paper §IV, batched) ---

    def save(self, path: str):
        """Snapshot the fleet: its real lanes + scenario metadata. Under a
        mesh the lanes are gathered from every rank and the padding lanes
        sliced off, so snapshots are mesh-portable; rank 0 writes, then
        every rank passes a barrier. The full per-lane specs ride in
        ``extra`` so a later consumer can map a spec back to its lane."""
        state = batch_mod.gather_over_fleet(self.state, self.mesh)
        state = SimState(*[x[:self.n_scenarios] for x in state])
        if self.mesh is None or self.mesh.get_rank() == 0:
            save_snapshot(path, state, self.cfg, self.windows_done,
                          extra={"scenario_names": self.names,
                                 "schedulers": [s.scheduler
                                                for s in self.specs],
                                 "specs": [dataclasses.asdict(s)
                                           for s in self.specs]})
        if self.mesh is not None:
            torch.distributed.barrier(
                group=self.mesh.get_group(batch_mod.FLEET_AXIS))

    def restore(self, path: str):
        """Resume mid-trace from a fleet snapshot (of either package, taken
        with or without a mesh): every rank reads the real lanes, pads them
        as the fleet was padded, and keeps its own block. Feed the fleet a
        window source that starts at the snapshot's window and keep its
        ``seed`` (``WindowedDriver.restore``)."""
        super().restore(path)
        if self.n_lanes != self.n_scenarios:
            pad = batch_mod.init_batched_state(
                self.cfg, self.n_lanes - self.n_scenarios, self.device)
            self.state = SimState(*[torch.cat([s, p]) for s, p
                                    in zip(self.state, pad)])
        self.state = batch_mod.shard_over_fleet(self.state, self.mesh)

    def _check_restorable(self, state):
        if state.window.shape[0] != self.n_scenarios:
            raise ValueError(
                f"snapshot holds {state.window.shape[0]} scenarios, fleet "
                f"has {self.n_scenarios}")
