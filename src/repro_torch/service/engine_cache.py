"""Warm engine + window cache behind the what-if server.

The port has no compiled program to keep: the fleet step is the same
PyTorch code and CUDA library for every batch. What a cold first query
would pay instead is loading the library, filling the caching allocator
and creating the library handles, which :meth:`EngineCache.warm` does with
one throwaway launch. Beside that this module keeps:

* a cached per-config *template* SimState, so ``fresh_lanes`` builds each
  batch's (B, ...) start state by copying it instead of re-running
  ``init_state``. The copies own their storage: ``run_scenarios`` updates
  the state in place, so a broadcast view of the template would alias
  every lane (or refuse the write);
* an LRU of device-resident window chunks keyed by (stack path, lo, hi) —
  repeated queries over the same trace range skip the npz decompression
  *and* the host-to-device copy (hit/miss counters exposed for telemetry);
* the per-program circuit breakers.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import SimConfig
from repro_torch.core.events import (EventWindow, empty_window, stack_windows,
                                     window_to_torch)
from repro_torch.core.precompile import load_window_range
from repro_torch.core.state import SimState, init_state
from repro_torch.device import resolve_device
from repro_torch.resilience.faults import maybe_fault
from repro_torch.resilience.policy import BreakerPolicy, CircuitBreaker
from repro_torch.scenarios import batch as batch_mod
from repro_torch.scenarios.spec import ScenarioSpec, build_knobs_for_table
from repro_torch.sched import snapshot_dispatch


class EngineCache:

    def __init__(self, cfg: SimConfig, window_cache_chunks: int = 16,
                 verify_chunks: bool = False, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.verify_chunks = verify_chunks
        self._template: Optional[SimState] = None
        self._lock = threading.Lock()
        self._windows: "collections.OrderedDict[Tuple, EventWindow]" = \
            collections.OrderedDict()
        self._capacity = max(1, window_cache_chunks)
        self._breakers: Dict[Tuple, CircuitBreaker] = {}
        self.hits = 0
        self.misses = 0
        self.warmed: set = set()   # (B, W, scheduler_names, has_storm) seen

    # --- lane states ---------------------------------------------------------

    def template_state(self) -> SimState:
        if self._template is None:
            self._template = init_state(self.cfg, self.device)
        return self._template

    def fresh_lanes(self, n: int) -> SimState:
        """(n, ...) empty worlds, each lane with its own storage (a batch
        updates its state in place; the template is never written)."""
        return SimState(*[x.unsqueeze(0).repeat((n,) + (1,) * x.dim())
                          for x in self.template_state()])

    # --- device window chunks ------------------------------------------------

    def window_chunk(self, path: str, lo: int, hi: int) -> EventWindow:
        """Device-resident (hi-lo, ...) stacked windows, LRU-cached.

        The cached tensors are owned by the cache; the fleet step reads its
        windows and never writes them, so one chunk can feed any number of
        batches.
        """
        key = (path, lo, hi)
        with self._lock:
            if key in self._windows:
                self._windows.move_to_end(key)
                self.hits += 1
                return self._windows[key]
            self.misses += 1
        maybe_fault("chunk_load")          # chaos: latency / transient loads
        host = load_window_range(path, lo, hi, verify=self.verify_chunks)
        dev = window_to_torch(host, self.device)
        with self._lock:
            self._windows[key] = dev
            while len(self._windows) > self._capacity:
                self._windows.popitem(last=False)
        return dev

    def cache_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "cached_chunks": len(self._windows)}

    # --- circuit breakers ----------------------------------------------------

    def breaker(self, key: Tuple, policy: BreakerPolicy,
                on_transition=None) -> CircuitBreaker:
        """The per-program circuit breaker (get-or-create). One breaker
        guards one warmed (B, W, schedulers, has_storm) entry, so a
        poisoned program fails fast without condemning the whole server."""
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(policy, on_transition=on_transition)
                self._breakers[key] = b
            return b

    def evict(self, key: Tuple, recompile: bool = True):
        """Drop a warmed entry — the breaker's hook for a poisoned program.

        ``recompile`` keeps the reference's signature: there the program's
        jit cache is cleared too. The port has no compiled program, and its
        CUDA library is not rebuilt, so dropping the key is all there is.
        """
        self.warmed.discard(key)

    # --- warm-up -------------------------------------------------------------

    def warm(self, n_lanes: int, batch_windows: int,
             scheduler_names: Tuple[str, ...], has_storm: bool = True):
        """Pay the first launch's fixed costs before the first query does.

        One launch of (n_lanes, ...) lanes over ``batch_windows`` PAD-only
        windows on a throwaway state: it loads the kernels' library, fills
        the caching allocator with the batch's buffers and creates the
        library handles the serving launches then reuse.
        """
        key = (n_lanes, batch_windows, tuple(scheduler_names), has_storm)
        if key in self.warmed:
            return
        pad = window_to_torch(
            stack_windows([empty_window(self.cfg)] * batch_windows),
            self.device)
        specs = [ScenarioSpec(name=f"_warm{i}", scheduler=scheduler_names[0])
                 for i in range(n_lanes)]
        knobs = build_knobs_for_table(specs, tuple(scheduler_names),
                                      self.device)
        state, stats = batch_mod.run_scenarios(
            self.fresh_lanes(n_lanes), pad, knobs, self.cfg,
            tuple(scheduler_names), 0, has_storm,
            table=snapshot_dispatch(tuple(scheduler_names)),
            lane_scheds=(0,) * n_lanes)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        del state, stats
        self.warmed.add(key)
