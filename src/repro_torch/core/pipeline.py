"""Host-side streaming pipeline: parser threads feeding the device.

Windows are parsed and tensorised on a fill thread into a bounded buffer
*ahead of simulation time* (default 30 sim-minutes, the paper's limit),
grouped into device batches of ``batch_windows`` windows, and handed to the
engine while the next batch is being parsed.

* On the card, each batch is staged into a ring of pinned host buffers and
  copied to the device with ``non_blocking`` copies on a side stream, on
  the fill thread; the consumer's stream waits on the copy's event, and a
  ring slot is refilled only after its copy has finished. So parsing,
  staging and the host-to-device copy of batch k+1 overlap the device work
  of batch k.
* The drive loop never reads a result back: stats rows stay on the device
  until ``stats_frame()`` materialises them. Runahead is bounded by
  ``WindowedDriver.max_inflight_batches`` (the loop waits on the oldest
  batch's event beyond it); the only full sync of a run is its last line.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.config import SimConfig
from repro_torch.core import engine as engine_mod
from repro_torch.core.events import EventWindow, stack_windows
from repro_torch.core.snapshot import load_snapshot
from repro_torch.core.state import SimState, drop, init_state, lift
from repro_torch.device import resolve_device
from repro_torch.sched import get_scheduler
from repro_torch.trace import span


class _StagingRing:
    """Ring of preallocated (W, ...) host buffers, pinned on a CUDA run.

    A slot is reused only after the device copy out of it has completed
    (its event), so a refill can never overwrite a batch in flight.
    """

    def __init__(self, proto: EventWindow, batch: int, pin: bool,
                 slots: int = 4):
        self.batch = batch
        self._ring = [
            EventWindow(*[torch.empty((batch,) + np.shape(f),
                                      dtype=torch.from_numpy(
                                          np.asarray(f)).dtype,
                                      pin_memory=pin) for f in proto])
            for _ in range(slots)]
        self.copied: List[Optional[torch.cuda.Event]] = [None] * slots
        self._i = 0

    def stage(self, windows: List[EventWindow]):
        """Copy ``windows`` into the next slot; returns (buffers, slot)."""
        i = self._i
        self._i = (i + 1) % len(self._ring)
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        buf = self._ring[i]
        for j, w in enumerate(windows):
            for dst, src in zip(buf, w):
                dst[j] = torch.from_numpy(np.asarray(src))
        return buf, i


class WindowPrefetcher:
    """Bounded-buffer producer/consumer over packed EventWindows.

    The source may yield single numpy windows (staged here into batches of
    ``batch_windows``) or pre-stacked (W, ...) batches — e.g. straight from
    ``core.precompile.replay_windows`` — which skip the staging ring; the
    consumer dequeues device-resident batches. ``buffer_occupancy()`` is
    the producer/consumer ledger of events, guarded by a lock (the fill
    thread writes one side, the consumer the other).
    """

    def __init__(self, cfg: SimConfig, window_iter: Iterator[EventWindow],
                 batch_windows: int = 32, device=None):
        self.cfg = cfg
        self.batch = batch_windows
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        depth = max(1, min(cfg.buffer_windows // max(batch_windows, 1), 64))
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._src = window_iter
        self._done = object()
        self._error: Optional[BaseException] = None
        self._drained = False
        self._lock = threading.Lock()
        self._events_in = 0       # staged into the buffer (fill thread)
        self._events_out = 0      # handed to the driver (consumer)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    @property
    def events_buffered(self) -> int:
        """Cumulative events staged into the buffer."""
        with self._lock:
            return self._events_in

    def buffer_occupancy(self) -> Dict[str, int]:
        """A consistent snapshot of the producer/consumer ledger."""
        with self._lock:
            return {"events_in_buffer": self._events_in - self._events_out,
                    "batches_in_buffer": self._q.qsize(),
                    "events_parsed": self._events_in,
                    "events_consumed": self._events_out}

    def _put(self, host: EventWindow, ring=None, slot=None):
        n = int(host.n_valid.sum())
        if self._cuda:
            with torch.cuda.stream(self._stream):
                dev = EventWindow(*[t.to(self.device, non_blocking=True)
                                    for t in host])
                copied = torch.cuda.Event()
                copied.record(self._stream)
            if ring is not None:
                ring.copied[slot] = copied
        else:
            # the ring slot is reused, so the batch gets its own storage
            dev, copied = EventWindow(*[t.clone() for t in host]), None
        with self._lock:
            self._events_in += n
        self._q.put((dev, copied, n))

    def _fill(self):
        batch: List[EventWindow] = []
        ring: Optional[_StagingRing] = None

        def put_stacked(stacked: EventWindow):
            with span("agocs.prefetch.stage_pageable"):
                self._put(EventWindow(*[
                    torch.from_numpy(np.ascontiguousarray(f))
                    for f in stacked]))

        def flush():
            if len(batch) == self.batch:
                with span("agocs.prefetch.stage"):
                    host, slot = ring.stage(batch)
                    self._put(host, ring, slot)
            else:                         # short tail batch
                put_stacked(stack_windows(batch))
            batch.clear()

        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            for w in self._src:
                if np.ndim(w.kind) == 2:      # pre-stacked (W, E) batch
                    if batch:                 # keep arrival order
                        flush()
                    put_stacked(w)
                    continue
                if ring is None:
                    ring = _StagingRing(w, self.batch, pin=self._cuda)
                batch.append(w)
                if len(batch) == self.batch:
                    flush()
            if batch:
                flush()
        except BaseException as e:            # surfaced on the consumer
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while not self._drained:
            with span("agocs.driver.next_batch"):
                item = self._q.get()
                if item is not self._done:
                    dev, copied, n = item
                    with self._lock:
                        self._events_out += n
                    if copied is not None:
                        stream = torch.cuda.current_stream(self.device)
                        stream.wait_event(copied)
                        for t in dev:         # allocated on the side stream
                            t.record_stream(stream)
            if item is self._done:
                break
            yield dev
        # drained: a later iteration ends at once instead of waiting for a
        # batch that never comes
        self._drained = True
        if self._error is not None:
            raise self._error


def restored_resync_phase(windows_done: int, batch_windows: int,
                          resync_windows: int) -> int:
    """The ``_since_resync`` counter a from-zero driver holds after
    ``windows_done`` windows of constant ``batch_windows``-sized batches:
    with batches of k windows the resync lands every
    ``ceil(resync_windows / k) * k`` windows."""
    if not resync_windows:
        return 0
    k = max(1, batch_windows)
    cadence = ((resync_windows + k - 1) // k) * k
    return windows_done % cadence


class WindowedDriver:
    """Shared drive loop: prefetcher -> engine -> stats/pacing/resync.

    Subclasses own ``self.state`` and implement ``_advance(batch, seed)``
    (consume one stacked window batch, update ``self.state``, return the
    stats rows). The loop is sync-free in the steady state; once more than
    ``max_inflight_batches`` batches are outstanding it waits for the
    oldest, and a run ends with one synchronisation. :meth:`pause` and
    :meth:`resume` hold and release the loop from another thread, between
    batches.

    Under a mesh (``ScenarioFleet(mesh=)``) every rank runs this loop over
    the same windows with the same per-batch seeds: where the reference
    replicates one parse to every device, here each rank reads the same
    source (a pre-compiled stack makes that a zero-parse read).
    """

    state: SimState
    max_inflight_batches: int = 4

    def __init__(self, cfg: SimConfig, window_source: Iterator[EventWindow],
                 batch_windows: int = 32, seed: Optional[int] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # under stats decimation every full batch emits whole stats chunks
        if cfg.stats_stride > 1:
            k = cfg.stats_stride
            batch_windows = ((batch_windows + k - 1) // k) * k
        self.prefetcher = WindowPrefetcher(cfg, window_source, batch_windows,
                                           self.device)
        self.seed = cfg.seed if seed is None else seed
        self.stats_rows: List[Dict[str, torch.Tensor]] = []
        self._row_windows: List[int] = []
        self.windows_done = 0
        self.resyncs_done = 0
        self._since_resync = 0
        self._inflight: "collections.deque" = collections.deque()
        self._paused = threading.Event()

    def _advance(self, batch: EventWindow, seed: int):
        raise NotImplementedError

    def _resync(self) -> SimState:
        """Full accounting recompute (subclass hook; identity by default)."""
        return self.state

    def _batch_done(self):
        """An event that completes with the batch just enqueued: what the
        run-ahead bound waits on (None on the CPU, where every call has
        finished when it returns)."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def pause(self):
        """Hold the drive loop before its next batch (from any thread)."""
        self._paused.set()

    def resume(self):
        self._paused.clear()

    def run(self, max_windows: Optional[int] = None,
            on_batch: Optional[Callable] = None) -> SimState:
        """Drive the source to its end, or until ``windows_done`` reaches
        ``max_windows`` (checked after each batch, as the reference does).

        ``on_batch(self)`` is called after each batch's resync, before the
        pacing sleep, so it sees the state the next batch starts from; the
        state's tables are updated in place by that batch, so a hook that
        keeps them clones them.
        """
        t_start = time.time()
        resync_every = (self.cfg.resync_windows
                        if self.cfg.incremental_accounting else 0)
        for batch in self.prefetcher:
            while self._paused.is_set():
                time.sleep(0.01)
            W = batch.kind.shape[0]
            with span("agocs.driver.advance"):
                stats = self._advance(batch, self.seed + self.windows_done)
            k = self.cfg.stats_stride
            m, r = divmod(W, k)
            self._row_windows.extend(
                [self.windows_done + (j + 1) * k for j in range(m)]
                + ([self.windows_done + W] if r else []))
            self.windows_done += W
            self.stats_rows.append(stats)
            done = self._batch_done()
            if done is not None:
                self._inflight.append(done)
                if len(self._inflight) > self.max_inflight_batches:
                    with span("agocs.driver.runahead"):
                        self._inflight.popleft().synchronize()
            if resync_every:
                self._since_resync += W
                if self._since_resync >= resync_every:
                    with span("agocs.driver.resync"):
                        self.state = self._resync()
                    self.resyncs_done += 1
                    self._since_resync = 0
            if on_batch is not None:
                on_batch(self)
            if self.cfg.speed_factor > 0:
                sim_elapsed = self.windows_done * self.cfg.window_us / 1e6
                lag = (sim_elapsed / self.cfg.speed_factor
                       - (time.time() - t_start))
                if lag > 0:
                    time.sleep(lag)
            if max_windows is not None and self.windows_done >= max_windows:
                break
        self._synchronize()
        self._inflight.clear()
        return self.state

    def _check_restorable(self, state: SimState):
        """Refuse a snapshot whose state does not fit this driver (subclass
        hook; a single trajectory takes one with the same field shapes)."""
        for f in state._fields:
            have, got = getattr(self.state, f).shape, getattr(state, f).shape
            if have != got:
                raise ValueError(f"snapshot field {f} has shape "
                                 f"{tuple(got)}, this driver {tuple(have)}")

    def restore(self, path: str):
        """Resume mid-trace from a snapshot (of either package), onto this
        driver's device.

        Feed the driver a window source that starts at the snapshot's
        window and keep its ``seed``: each batch's keys derive from ``seed
        + windows_done``, the seed the uninterrupted run gave that batch,
        and the resync cadence is re-phased to the from-zero schedule
        (:func:`restored_resync_phase`), so the resumed run is bitwise the
        uninterrupted one, stochastic schedulers included.
        """
        state, cfg, windows_done, _extra = load_snapshot(path,
                                                         device=self.device)
        self._check_restorable(state)
        if cfg != self.cfg:
            raise ValueError(f"snapshot config differs from "
                             f"{type(self).__name__} config")
        self.state = state
        self.windows_done = windows_done
        self._since_resync = restored_resync_phase(
            windows_done, self.prefetcher.batch,
            self.cfg.resync_windows if self.cfg.incremental_accounting else 0)

    def stats_window_indices(self) -> np.ndarray:
        """The cumulative window count each stats row was emitted at."""
        return np.asarray(self._row_windows, dtype=np.int64)

    def stats_frame(self) -> Dict[str, np.ndarray]:
        """Concatenate per-batch stat rows into (n_rows, ...) host arrays.

        The materialisation point of the device-resident stats stream:
        rows are copied to the host here, once, in place.
        """
        if not self.stats_rows:
            return {}
        for i, r in enumerate(self.stats_rows):
            self.stats_rows[i] = {
                k: np.atleast_1d(v.cpu().numpy() if isinstance(v, torch.Tensor)
                                 else v) for k, v in r.items()}
        keys = self.stats_rows[0].keys()
        frame = {k: np.concatenate([r[k] for r in self.stats_rows])
                 for k in keys}
        n_rows = len(next(iter(frame.values())))
        assert n_rows == len(self._row_windows), (
            f"stats cadence drift: {n_rows} frame rows vs "
            f"{len(self._row_windows)} tracked window indices")
        return frame


class Simulation(WindowedDriver):
    """End-to-end driver: trace source -> prefetcher -> engine, on the card
    unless ``device="cpu"`` is passed.

    Resumes from a snapshot (``core.snapshot``) with :meth:`restore`.
    """

    def __init__(self, cfg: SimConfig, window_source: Iterator[EventWindow],
                 scheduler: Optional[str] = None, batch_windows: int = 32,
                 seed: Optional[int] = None, device=None):
        self.scheduler = scheduler or cfg.scheduler
        self._scheduler_fn = get_scheduler(self.scheduler)   # fail fast
        super().__init__(cfg, window_source, batch_windows, seed, device)
        self.state = init_state(cfg, self.device)

    def _advance(self, batch: EventWindow, seed: int):
        self.state, stats = engine_mod.run_windows(
            self.state, batch, self.cfg, self._scheduler_fn, seed)
        return stats

    def _resync(self):
        return drop(engine_mod.recompute_accounting(lift(self.state),
                                                    self.cfg))
