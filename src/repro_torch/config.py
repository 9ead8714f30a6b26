"""The simulator's configuration: a copy of the reference's ``SimConfig``.

Field for field and default for default the dataclass of ``repro.config``
(tests hold the two equal), kept here so that the port imports nothing of
the reference package. ``use_kernels`` and ``fused_window_stats`` stay
fields so that configs compare equal, but the port does not read them: a
CUDA tensor always takes the hand-written kernel and a CPU tensor its plain
PyTorch version.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class SimConfig:
    """AGOCS engine configuration.

    Defaults mirror the paper: 5-second collection windows, 5 parser workers,
    buffers of <=1e6 events / 30 sim-minutes ahead, GCD cell with 12.5K nodes.
    """
    max_nodes: int = 12_500
    max_tasks: int = 262_144          # live-task slots (GCD ~140K running)
    max_events_per_window: int = 8_192
    window_us: int = 5_000_000        # 5 sim-seconds (paper's collection tick)
    n_resources: int = 3              # cpu, memory, disk
    n_usage_stats: int = 8            # cpu, canon-mem, assigned-mem, page-cache,
                                      # disk-io-time, disk-space, cpi, mai
    n_attr_slots: int = 16            # node attribute columns
    max_constraints: int = 6          # per-task constraint slots
    n_parser_workers: int = 5         # paper's 5 Akka actors
    buffer_windows: int = 360         # 30 sim-minutes of 5s windows
    buffer_max_events: int = 1_000_000
    speed_factor: float = 0.0         # 0 = as-fast-as-possible; else real-time x N
    scheduler: str = "greedy"
    sched_batch: int = 1_024          # max pending tasks considered per window
    seed: int = 0
    use_kernels: bool = False         # read by the reference only: the
                                      # port dispatches on the tensor's
                                      # device (CUDA -> kernel, CPU -> plain)
    incremental_accounting: bool = True
                                      # maintain node_reserved/node_used by
                                      # per-event deltas (O(events) per window)
                                      # instead of full segment-sum recomputes
                                      # (O(max_tasks), three times per window).
                                      # False restores the pre-delta full
                                      # recompute path — kept for the
                                      # equivalence suite and as the fallback
                                      # if a trace violates the pipeline's
                                      # one-update-per-(slot, field-group)
                                      # window guarantee
    resync_windows: int = 64          # full segment-sum resync cadence under
                                      # incremental accounting: the drivers
                                      # recompute both tallies from the task
                                      # table every ~resync_windows windows
                                      # (rounded up to a batch boundary),
                                      # bounding float accumulation drift.
                                      # 0 disables the resync
    fused_window_stats: bool = True   # read by the reference only: the
                                      # port always builds each stats row
                                      # from the fused pass
                                      # (kernels/window_stats); its
                                      # pre-fusion body
                                      # (core.stats.window_stats_ref) is the
                                      # oracle tests call directly
    stats_stride: int = 1             # emit a stats row every k-th window
                                      # (headless sweeps): the engines scan
                                      # k windows per stats row, so skipped
                                      # windows pay ZERO stats cost. Counters
                                      # are cumulative in SimState (and the
                                      # fleet's per-window injected count is
                                      # accumulated across the chunk), so no
                                      # events are lost — each emitted row
                                      # equals the corresponding stride-1
                                      # row. Drivers round batch_windows up
                                      # to a multiple of the stride; a
                                      # short tail batch still emits a final
                                      # partial row so the run always ends
                                      # on a reported state
    storm_max_victims: int = 0        # per-window cap on eviction-storm
                                      # victims (scenario fleets). Victims
                                      # up to the cap are *compacted* — a
                                      # searchsorted over the victim cumsum
                                      # gathers the <=V victim rows, and the
                                      # incremental accounting debit becomes
                                      # an O(V) delta scatter instead of a
                                      # masked O(max_tasks) segment-sum per
                                      # storm lane per window. 0 = auto
                                      # (max_tasks // 8, at least 64);
                                      # >= max_tasks disables the cap AND
                                      # the compaction (the legacy
                                      # masked-segment-sum debit). NOTE a
                                      # *binding* cap truncates the storm
                                      # AND keeps the lowest-slot hits
                                      # (slot order, not a uniform
                                      # subsample) — size it above
                                      # storm_frac x expected running tasks,
                                      # or set >= max_tasks for unbounded
                                      # storms
    trace_time_shift_us: int = 600_000_000  # GCD's 10-minute shift
    scenario_salt: int = 0x5DEECE66   # seeds the deterministic perturbation
                                      # hashes of the what-if scenario fleet
                                      # (repro/scenarios) — change to resample
                                      # outage/thinning victim sets
    inject_slots: int = 0             # event rows per window reserved for
                                      # scenario event *injection* (the last
                                      # inject_slots rows of every packed
                                      # window stay PAD; perturb.py fills them
                                      # with synthesised SUBMITs, so arrival
                                      # amplification > 1 adds real load)
    inject_task_slots: int = 0        # task-slot pool reserved for injected
                                      # tasks at the top of the task table
                                      # (0 = auto-size from inject_slots);
                                      # injected slot ids wrap modulo the pool
    sched_dispatch: str = "auto"      # fleet scheduler dispatch: 'auto' goes
                                      # switchless (grouped proposal-table
                                      # evaluation, no lax.switch) whenever
                                      # every lane's scheduler registered a
                                      # table form, falling back to the
                                      # lax.switch path otherwise; 'switch'
                                      # forces the fallback; 'table' demands
                                      # switchless and errors if any lane's
                                      # scheduler is opaque (no table form)
    commit_tile_p: int = 0            # placement-commit task tile rows per
                                      # grid step (0 = kernel default: whole
                                      # batch under interpret, 128 on TPU)
    commit_tile_n: int = 0            # node-streaming tile for the commit /
                                      # fused scheduler pass: 0 keeps the
                                      # node dim whole per grid step; k > 0
                                      # streams (B, k) score blocks with a
                                      # cross-tile argmax carry so the pass
                                      # holds at full-cell node counts
                                      # (N=12,500) without an HBM-resident
                                      # (B, P, N) preference tensor

    def __post_init__(self):
        if self.sched_dispatch not in ("auto", "switch", "table"):
            raise ValueError(
                f"sched_dispatch={self.sched_dispatch!r} not in "
                "('auto', 'switch', 'table')")
        if self.commit_tile_p < 0 or self.commit_tile_n < 0:
            raise ValueError("commit_tile_p / commit_tile_n must be >= 0 "
                             "(0 = kernel default / whole node dim)")
        if self.inject_slots < 0 or self.inject_task_slots < 0:
            raise ValueError("inject_slots / inject_task_slots must be >= 0")
        if self.resync_windows < 0:
            raise ValueError("resync_windows must be >= 0 (0 disables)")
        if self.stats_stride < 1:
            raise ValueError("stats_stride must be >= 1 (1 = every window)")
        if self.storm_max_victims < 0:
            raise ValueError("storm_max_victims must be >= 0 (0 = auto)")
        if self.inject_slots >= self.max_events_per_window:
            raise ValueError(
                f"inject_slots={self.inject_slots} leaves no event rows "
                f"(max_events_per_window={self.max_events_per_window})")
        pool = self.resolved_inject_task_slots
        if pool >= self.max_tasks:
            raise ValueError(
                f"inject task pool {pool} leaves no real task slots "
                f"(max_tasks={self.max_tasks})")
        if self.inject_slots and pool < self.inject_slots:
            raise ValueError(
                f"inject task pool {pool} < inject_slots="
                f"{self.inject_slots}: one window's injections would "
                "collide with each other")

    @property
    def resolved_inject_task_slots(self) -> int:
        """Task-slot pool for injected tasks (auto: 64 windows' worth)."""
        if not self.inject_slots:
            return 0
        return self.inject_task_slots or min(self.max_tasks // 4,
                                             self.inject_slots * 64)

    @property
    def resolved_storm_max_victims(self) -> int:
        """Eviction-storm victim cap (auto: max_tasks // 8, at least 64).

        Values >= max_tasks mean 'uncapped': the storm keeps the legacy
        masked segment-sum debit instead of the victim-compacted scatter.
        """
        if self.storm_max_victims:
            return min(self.storm_max_victims, self.max_tasks)
        return min(max(self.max_tasks // 8, 64), self.max_tasks)

    @property
    def real_task_slots(self) -> int:
        """Task slots available to the parser; [real_task_slots, max_tasks)
        is the injection pool, so injected ids never collide with trace ids."""
        return self.max_tasks - self.resolved_inject_task_slots

    @property
    def events_per_window(self) -> int:
        """Rows available to parsed (real) events in each packed window."""
        return self.max_events_per_window - self.inject_slots

    def scaled(self, nodes: int, tasks: int) -> "SimConfig":
        return replace(self, max_nodes=nodes, max_tasks=tasks)


REDUCED_SIM = SimConfig(max_nodes=64, max_tasks=512, max_events_per_window=256,
                        n_attr_slots=8, max_constraints=4, buffer_windows=16,
                        buffer_max_events=4096, sched_batch=64)
