"""The port's drive loop and prefetcher (``repro_torch.core.pipeline``),
the counterpart of ``tests/test_pipeline_async.py``:

* ``run`` synchronises once (``WindowedDriver._synchronize``) and leaves
  the stats rows as device tensors until ``stats_frame`` materialises
  them, once, in place (0-d and host rows normalised);
* the run-ahead is bounded: beyond ``max_inflight_batches`` outstanding
  batches the loop waits on the oldest batch's event (counted through the
  ``_batch_done`` hook, which gives CUDA events on the card);
* the prefetcher's occupancy ledger balances, and a drained prefetcher
  iterates empty again;
* batches are device-resident and unaliased: with more batches than the
  staging ring has slots, every yielded batch still equals ``np.stack``
  of its windows, and a short tail batch is stacked on its own;
* the stats frame under striding (``stats_window_indices``);
* the resync fires on its cadence and restores the exact recompute.

Where the reference checks a JAX-only mechanism, the property the port's
pinned ring and in-place engine owe instead: ``_StagingPool``'s tail
fallback is the ring's short-tail batch above, and ``run_windows_jit``'s
donation is ``run_windows`` taking ownership of the state (its tables
updated in place, no second copy).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.config import REDUCED_SIM
from repro_torch.core import engine as eng
from repro_torch.core import pipeline as pipe
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import drop, init_state, lift
from repro_torch.sched import get_scheduler

torch.set_num_threads(1)

CFG = dataclasses.replace(REDUCED_SIM, max_nodes=16, max_tasks=96,
                          max_events_per_window=64, sched_batch=24)


def _windows(n, cfg=CFG, tasks_per=3):
    out = [pack_window(cfg, [HostEvent(0, EventKind.ADD_NODE, m,
                                       a=(1.0, 1.0, 1.0))
                             for m in range(8)], 0)]
    slot = 0
    for i in range(1, n):
        evs = []
        for _ in range(tasks_per):
            evs.append(HostEvent(1, EventKind.ADD_TASK, slot % 48,
                                 a=(0.125, 0.125, 0.0)))
            slot += 1
        out.append(pack_window(cfg, evs, i))
    return out


def _sim(cfg=CFG, n=12, batch=4):
    return pipe.Simulation(cfg, iter(_windows(n, cfg=cfg)),
                           batch_windows=batch, device="cpu")


@pytest.fixture
def syncs(monkeypatch):
    calls = []
    real = pipe.WindowedDriver._synchronize
    monkeypatch.setattr(pipe.WindowedDriver, "_synchronize",
                        lambda self: calls.append(1) or real(self))
    return calls


def test_run_syncs_once_and_keeps_stats_on_device(syncs):
    """One synchronisation per run(), and the accumulated stats rows are
    still tensors afterwards (nothing forced them to the host)."""
    sim = _sim()
    sim.run()
    assert len(syncs) == 1
    assert sim.windows_done == 12
    assert len(sim.stats_rows) == 3
    for row in sim.stats_rows:
        for v in row.values():
            assert isinstance(v, torch.Tensor), type(v)
    # materialisation happens in stats_frame, once, in place
    frame = sim.stats_frame()
    assert all(isinstance(v, np.ndarray) for v in frame.values())
    assert frame["n_running"].shape == (12,)
    for row in sim.stats_rows:
        for v in row.values():
            assert isinstance(v, np.ndarray)


class _Event:
    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append(1)


def test_runahead_is_bounded(syncs):
    """Dispatch may run ahead of the device only by max_inflight_batches;
    beyond that the loop waits on the oldest outstanding batch."""
    waits = []

    class Bounded(pipe.Simulation):
        def _batch_done(self):
            return _Event(waits)

    sim = Bounded(CFG, iter(_windows(12)), batch_windows=4, device="cpu")
    sim.max_inflight_batches = 1
    sim.run()
    # 3 batches: batches 2 and 3 each wait on an older one, plus the final
    # drain — backpressure without a sync on every batch
    assert len(waits) == 2 and len(syncs) == 1
    assert not sim._inflight
    # the CPU has no event to wait on: every call ran to its end
    assert _sim()._batch_done() is None


def test_stats_frame_normalises_scalar_and_host_rows():
    """0-d per-batch rows and mixed host/tensor rows normalise to length-1
    vectors at materialisation and concatenate cleanly (one row a batch:
    the stride is the batch)."""

    class ScalarDriver(pipe.WindowedDriver):
        def __init__(self, cfg, src, batch_windows):
            super().__init__(cfg, src, batch_windows, device="cpu")
            self.state = init_state(cfg, "cpu")
            self._i = 0

        def _advance(self, batch, seed):
            self._i += 1
            dev = self._i % 2 == 0
            return {"batch_idx": (torch.tensor(self._i) if dev
                                  else np.asarray(self._i)),     # 0-d row
                    "per_row": torch.zeros(1) if dev else np.zeros(1)}

    cfg = dataclasses.replace(CFG, stats_stride=4)
    drv = ScalarDriver(cfg, iter(_windows(12, cfg=cfg)), batch_windows=4)
    drv.run()
    frame = drv.stats_frame()
    np.testing.assert_array_equal(frame["batch_idx"], [1, 2, 3])
    assert frame["per_row"].shape == (3,)
    np.testing.assert_array_equal(drv.stats_window_indices(), [4, 8, 12])


def test_prefetcher_occupancy_ledger_balances():
    ws = _windows(10)
    pf = pipe.WindowPrefetcher(CFG, iter(ws), batch_windows=4, device="cpu")
    batches = list(pf)
    assert sum(b.kind.shape[0] for b in batches) == 10
    occ = pf.buffer_occupancy()
    total = int(sum(int(w.n_valid) for w in ws))
    assert occ == {"events_in_buffer": 0, "batches_in_buffer": 0,
                   "events_parsed": total, "events_consumed": total}
    assert pf.events_buffered == total


def test_prefetcher_batches_are_resident_and_unaliased():
    """The staging ring never aliases an already-yielded batch: with more
    batches than ring slots, every yielded batch still matches a np.stack
    of its windows bit-for-bit."""
    cfg = dataclasses.replace(CFG, buffer_windows=1000)
    ws = _windows(40, cfg=cfg)
    ref = [stack_windows(ws[i:i + 2]) for i in range(0, 40, 2)]
    pf = pipe.WindowPrefetcher(cfg, iter(ws), batch_windows=2, device="cpu")
    got = list(pf)
    assert len(got) == len(ref)
    for g in got:
        assert isinstance(g.kind, torch.Tensor) and g.kind.device == pf.device
    for g, r in zip(got, ref):
        for name in r._fields:
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          getattr(r, name), err_msg=name)


def test_staging_ring_tail_batch_stacks_alone():
    ws = _windows(5)
    pf = pipe.WindowPrefetcher(CFG, iter(ws), batch_windows=4, device="cpu")
    got = list(pf)
    assert [b.kind.shape[0] for b in got] == [4, 1]
    np.testing.assert_array_equal(got[1].kind.numpy(), ws[4].kind[None])


def test_drained_prefetcher_iterates_empty_again():
    """Once its source is drained, a second pass over the prefetcher ends
    at once (a driver whose stream ran dry, then a drain of the fill
    thread) instead of waiting for a batch that never comes."""
    pf = pipe.WindowPrefetcher(CFG, iter(_windows(5)), batch_windows=4,
                               device="cpu")
    assert [b.kind.shape[0] for b in pf] == [4, 1]
    again = []
    t = threading.Thread(target=lambda: again.append(list(pf)), daemon=True)
    t.start()
    t.join(30)
    assert again == [[]]


def test_run_windows_takes_ownership_of_the_state():
    """The port's counterpart of donation: the (T, ...) task tables are
    updated in place and back the returned state, with no second copy."""
    ws = window_to_torch(stack_windows(_windows(4)), "cpu")
    state = init_state(CFG, "cpu")
    ptrs = {f: getattr(state, f).data_ptr() for f in state._fields
            if f.startswith("task_")}
    out, _ = eng.run_windows(state, ws, CFG, get_scheduler("greedy"), 0)
    for f, p in ptrs.items():
        assert getattr(out, f).data_ptr() == p, f
    assert int(out.task_state.sum()) > 0


@pytest.mark.parametrize("stride", [2, 4, 5])
def test_stats_frame_semantics_under_striding(stride, syncs):
    """Stats decimation through the driver: frame length is the emitted
    row count, stats_window_indices() names each row's window, the final
    window is always reported, and the loop still syncs once per run()."""
    cfg = dataclasses.replace(CFG, stats_stride=stride)
    W = 14
    sim = _sim(cfg, n=W)
    sim.run()
    assert len(syncs) == 1
    assert sim.windows_done == W
    # the driver rounds batch_windows up to a stride multiple, so full
    # batches emit whole chunks and only the run's tail row is partial
    batch = max(4, ((4 + stride - 1) // stride) * stride)
    rows, left = 0, W
    while left > 0:
        w = min(batch, left)
        rows += -(-w // stride)
        left -= w
    frame = sim.stats_frame()
    assert frame["n_running"].shape == (rows,)
    idx = sim.stats_window_indices()
    assert idx.shape == (rows,)
    assert idx[-1] == W                   # final state always reported
    assert all(b - a >= 1 for a, b in zip(idx, idx[1:]))
    # each strided row equals the stride-1 row at the same window
    ref = _sim(n=W)
    ref.run()
    rf = ref.stats_frame()
    for k in ("n_running", "n_pending", "completions", "evictions",
              "placements"):
        np.testing.assert_array_equal(frame[k], rf[k][idx - 1], err_msg=k)
    for f in sim.state._fields:
        assert torch.equal(getattr(sim.state, f), getattr(ref.state, f)), f


def test_stats_window_indices_stride_one_is_identity():
    sim = _sim()
    sim.run()
    np.testing.assert_array_equal(sim.stats_window_indices(),
                                  np.arange(1, 13))
    assert sim.stats_frame()["n_running"].shape == (12,)


def test_resync_fires_on_cadence():
    cfg = dataclasses.replace(CFG, resync_windows=8)
    sim = _sim(cfg, n=16)
    sim.run()
    assert sim.resyncs_done == 2
    # full-recompute mode never resyncs (nothing drifts)
    cfg_f = dataclasses.replace(cfg, incremental_accounting=False)
    sim_f = _sim(cfg_f, n=16)
    sim_f.run()
    assert sim_f.resyncs_done == 0


def test_resync_restores_exact_recompute():
    """The driver's resync on a drifted state == recompute_accounting, and
    on these grid values == the tallies before the drift."""
    sim = _sim(n=6, batch=6)
    state = sim.run()
    good = (state.node_reserved.clone(), state.node_used.clone())
    # poison the tallies; the resync must rebuild them from the task table
    sim.state = state._replace(node_reserved=state.node_reserved + 0.5,
                               node_used=state.node_used - 0.25)
    oracle = drop(eng.recompute_accounting(lift(sim.state), CFG))
    fixed = sim._resync()
    assert torch.equal(fixed.node_reserved, oracle.node_reserved)
    assert torch.equal(fixed.node_used, oracle.node_used)
    assert torch.equal(fixed.node_reserved, good[0])
    assert torch.equal(fixed.node_used, good[1])
    assert float(good[0].sum()) > 0
