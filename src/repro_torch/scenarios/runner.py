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
resumed run is bitwise the uninterrupted one). Not ported
yet: the mesh-sharded fleet (``mesh=``), which raises and names its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

from repro_torch.config import SimConfig
from repro_torch.core.events import EventWindow
from repro_torch.core.pipeline import WindowedDriver
from repro_torch.core.snapshot import save_snapshot
from repro_torch.scenarios import batch as batch_mod
from repro_torch.scenarios.report import scenario_report
from repro_torch.scenarios.spec import ScenarioSpec, build_knobs
from repro_torch.sched import snapshot_dispatch

MESH_LATER = ("the mesh-sharded fleet waits for a later slice of the port "
              "(lanes split across cards with torch.distributed)")


class ScenarioFleet(WindowedDriver):
    """End-to-end batched what-if driver, on the card unless
    ``device="cpu"`` is passed.

    >>> specs = expand_grid(scheduler=["greedy", "first_fit"],
    ...                     node_outage_frac=[0.0, 0.2])
    >>> fleet = ScenarioFleet(cfg, parser.packed_windows(200), specs)
    >>> fleet.run()
    >>> print(format_table(fleet.report()))
    """

    def __init__(self, cfg: SimConfig, window_source: Iterator[EventWindow],
                 specs: Sequence[ScenarioSpec], batch_windows: int = 32,
                 seed: Optional[int] = None, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(MESH_LATER)
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
        # storm-free fleets drop the eviction-storm pass entirely
        self._has_storm = any(s.evict_storm_frac > 0.0 for s in self.specs)
        self.knobs, self.scheduler_names = build_knobs(self.specs,
                                                       self.device)
        # the dispatch contract, frozen now: plugins registered after
        # construction cannot retarget this fleet's scheduler indices
        self.dispatch_table = snapshot_dispatch(self.scheduler_names)
        self._lane_scheds = tuple(self.scheduler_names.index(s.scheduler)
                                  for s in self.specs)
        self.state = batch_mod.init_batched_state(cfg, len(self.specs),
                                                  self.device)

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
    def names(self) -> List[str]:
        return [s.name for s in self.specs]

    def _advance(self, batch: EventWindow, seed: int):
        self.state, stats = batch_mod.run_scenarios(
            self.state, batch, self.knobs, self.cfg, self.scheduler_names,
            seed, has_storm=self._has_storm, table=self.dispatch_table,
            lane_scheds=self._lane_scheds)
        return stats

    def _resync(self):
        return batch_mod.resync_fleet(self.state, self.cfg)

    def report(self, baseline: int = 0) -> dict:
        return scenario_report(self.names, self.stats_frame(),
                               [s.scheduler for s in self.specs],
                               baseline=baseline)

    # --- pause/snapshot/resume (paper §IV, batched) ---

    def save(self, path: str):
        """Snapshot the fleet: its lane-batched state + scenario metadata.
        The full per-lane specs ride in ``extra`` so a later consumer can
        map a spec back to its lane."""
        save_snapshot(path, self.state, self.cfg, self.windows_done,
                      extra={"scenario_names": self.names,
                             "schedulers": [s.scheduler for s in self.specs],
                             "specs": [dataclasses.asdict(s)
                                       for s in self.specs]})

    def _check_restorable(self, state):
        if state.window.shape[0] != self.n_scenarios:
            raise ValueError(
                f"snapshot holds {state.window.shape[0]} scenarios, fleet "
                f"has {self.n_scenarios}")
