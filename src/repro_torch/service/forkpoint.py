"""Fork points: periodic mid-trace fleet snapshots queries can start from.

A fork point is a (B, ...) device-resident SimState captured at window W of
a *trunk* fleet run (the fork specs, simulated from window 0), plus the
per-lane specs so a later query can be matched to the lane whose world it
wants to continue. Starting a query at W then costs replaying
``n_windows`` windows instead of ``W + n_windows`` — combined with
``core.precompile.load_window_range`` it never touches the first W windows
of the stack at all.

Bitwise contract (tested in tests/test_torch_service.py): a
fork-continuation is identical to the corresponding lane of a from-zero run
**iff** the service replays the same window chunking (equal
``batch_windows``), derives chunk seeds as ``base_seed + absolute_window``
(the WindowedDriver schedule), and re-phases the incremental-accounting
resync cadence — all of which ``WhatIfServer._run_batch`` does. Fork
windows must therefore land on ``batch_windows`` boundaries;
:func:`build_fork_points` enforces it.

Capture beware: the fleet updates ``drv.state``'s tables in place, so the
on_batch hook clones the lanes it keeps before the next batch runs, and
:meth:`ForkPointStore.lane_state` hands out copies, so no launch ever
writes into the store.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.state import SimState
from repro_torch.resilience.faults import maybe_fault
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.service.protocol import spec_key


class ForkPointStore:
    """window -> ((B, ...) state, lane specs), plus spec->lane lookup.

    ``max_points`` bounds the store's device footprint: each point pins a
    full (B, ...) SimState on the card, so an unbounded store under
    refresh-on-advance (a trunk that keeps extending the fork frontier)
    accumulates snapshots forever. When the cap is hit the *oldest* window
    is evicted — from-zero queries (start_window 0) never consult the
    store, so dropping old fork points only lengthens the replay suffix
    for queries behind the frontier, never changes results. None keeps the
    store unbounded.
    """

    def __init__(self, max_points: Optional[int] = None):
        if max_points is not None and max_points < 1:
            raise ValueError(f"max_points={max_points} must be >= 1")
        self._lock = threading.Lock()
        self._points: Dict[int, Tuple[SimState, List[ScenarioSpec]]] = {}
        self.max_points = max_points

    def add(self, window: int, state: SimState,
            specs: Sequence[ScenarioSpec]):
        if state[0].shape[0] != len(specs):
            raise ValueError(f"state has {state[0].shape[0]} lanes, "
                             f"{len(specs)} specs")
        with self._lock:
            self._points[int(window)] = (state, list(specs))
            if self.max_points is not None:
                while len(self._points) > self.max_points:
                    del self._points[min(self._points)]

    @property
    def windows(self) -> List[int]:
        with self._lock:
            return sorted(self._points)

    def get(self, window: int) -> Tuple[SimState, List[ScenarioSpec]]:
        with self._lock:
            if window not in self._points:
                raise KeyError(
                    f"no fork point at window {window}; have {sorted(self._points)}")
            return self._points[window]

    def lane_for(self, window: int, spec: ScenarioSpec) -> int:
        """The trunk lane whose world ``spec`` continues (name ignored —
        the query may relabel the scenario)."""
        _, specs = self.get(window)
        want = spec_key(spec)
        for i, s in enumerate(specs):
            if spec_key(s) == want:
                return i
        raise KeyError(
            f"spec {spec.describe()!r} matches no fork lane at window "
            f"{window}; lanes: {[s.describe() for s in specs]}")

    def lane_state(self, window: int, lanes: Sequence[int]) -> SimState:
        """(len(lanes), ...) gather of the fork state's lanes; a copy
        (``index_select``), which the launch then updates in place."""
        maybe_fault("fork_restore")        # chaos: failed/slow restores
        state, _ = self.get(window)
        idx = torch.tensor(list(lanes), dtype=torch.long,
                           device=state[0].device)
        return SimState(*[x.index_select(0, idx) for x in state])

    def nearest_at_or_before(self, window: int) -> Optional[int]:
        ws = self.windows
        i = bisect.bisect_right(ws, window)
        return ws[i - 1] if i else None


def build_fork_points(fleet, every: int, store: Optional[ForkPointStore] = None
                      ) -> ForkPointStore:
    """Run ``fleet`` to completion, snapshotting its lanes every ``every``
    windows into a ForkPointStore (window 0 excluded; the final window
    included only if it lands on the cadence).

    ``every`` must be a multiple of the fleet's batch size: captures happen
    in the driver's on_batch hook, i.e. only at batch boundaries — and the
    bitwise fork-continuation contract needs fork windows aligned to the
    serving chunk grid anyway.
    """
    batch = fleet.prefetcher.batch
    if every <= 0 or every % batch:
        raise ValueError(f"fork cadence every={every} must be a positive "
                         f"multiple of batch_windows={batch}")
    store = store or ForkPointStore()

    def on_batch(drv):
        if drv.windows_done % every == 0:
            # clone NOW: the next batch updates drv.state's tables in place
            snap = SimState(*[x[:fleet.n_scenarios].clone()
                              for x in drv.state])
            store.add(drv.windows_done, snap, fleet.specs)

    fleet.run(on_batch=on_batch)
    return store
