"""The port's streaming pre-compile (``repro_torch.core.precompile``), the
counterpart of ``tests/test_ingest_stream.py``: the streaming writer
byte-identical to the legacy one (``streaming=False``) for chunked,
one-chunk and flat layouts; consumed windows freed within two chunks; a
split window's tail padding counted from the trace index; an out-of-range
``start_window`` refused on the caller's thread and by the ``whatif``
CLI; the parse stats persisted and round-tripped, and the overflow
warning; and the bounded fork-point store of the what-if service."""
import dataclasses
import gc
import hashlib
import weakref

import numpy as np
import pytest
import torch

from repro_torch.config import REDUCED_SIM
from repro_torch.core.events import EventKind, HostEvent, pack_window
from repro_torch.core.precompile import (overflow_warning, precompile_stream,
                                         precompile_trace, replay_windows,
                                         stack_n_windows, stack_parse_stats)
from repro_torch.core.state import init_state
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.parsers import base as parser_base
from repro_torch.parsers.base import ParseStats, TraceParser
from repro_torch.parsers.gcd import GCDParser

CFG = REDUCED_SIM
START = SHIFT_US - CFG.window_us
N = 37                                # deliberately not a shard multiple


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ingest"))
    generate_trace(d, n_machines=16, n_jobs=40, horizon_windows=N, seed=5,
                   usage_period_us=10_000_000)
    return d


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("shard", [0, 8, 64])
def test_streaming_bitwise_identical_to_legacy(trace_dir, tmp_path, shard):
    """The constant-memory writer produces byte-identical npz files to the
    materialise-everything writer, for chunked (shard 8), one-big-chunk
    (64 > N) and flat (shard 0) layouts."""
    a, b = str(tmp_path / "stream.npz"), str(tmp_path / "legacy.npz")
    na = precompile_trace(CFG, trace_dir, a, N, start_us=START,
                          shard_windows=shard, streaming=True)
    nb = precompile_trace(CFG, trace_dir, b, N, start_us=START,
                          shard_windows=shard, streaming=False)
    assert na == nb == N
    assert _sha(a) == _sha(b)


def test_streaming_does_not_retain_windows(trace_dir, tmp_path):
    """Peak memory is O(shard_windows): while the writer consumes window i,
    windows older than two chunks are already garbage."""
    shard = 4
    refs = []

    def spy_stream():
        parser = GCDParser(CFG, trace_dir)
        for i, w in enumerate(parser.packed_windows(N, start_us=START)):
            if i >= 3 * shard:
                gc.collect()
                alive = sum(r() is not None for r in refs[:i - 2 * shard])
                assert alive == 0, (f"window {i}: {alive} windows older "
                                    f"than 2 chunks still alive")
            refs.append(weakref.ref(w.kind))
            yield w

    out = str(tmp_path / "s.npz")
    precompile_stream(CFG, spy_stream(), out, N, shard_windows=shard)
    assert stack_n_windows(out) == N


class _OneWindowParser(TraceParser):
    """A fake family: every event lands in trace-window 0, 2.5x the
    real-event budget, so packed_windows must split it into 3 chunks."""

    def __init__(self, cfg, n_events):
        super().__init__(cfg, trace_dir="/nonexistent")
        self.n_events = n_events

    def events(self):
        for i in range(self.n_events):
            yield HostEvent(i, EventKind.UPDATE_TASK_USED, i)


def test_split_window_tail_padding_uses_trace_index(monkeypatch):
    """After an over-full window splits into k > 1 chunks, the tail padding
    continues from the true next trace-window index, not from the number of
    chunks emitted so far."""
    calls = []
    real = pack_window

    def spy(cfg, events, window_idx):
        calls.append((len(events), window_idx))
        return real(cfg, events, window_idx)

    monkeypatch.setattr(parser_base, "pack_window", spy)
    E = CFG.events_per_window
    parser = _OneWindowParser(CFG, n_events=2 * E + E // 2)
    out = list(parser.packed_windows(6, start_us=0))
    assert len(out) == 6
    # 3 split chunks of window 0, then pads at windows 1, 2, 3
    assert [c[1] for c in calls] == [0, 0, 0, 1, 2, 3]
    assert [c[0] for c in calls[:3]] == [E, E, E // 2]
    # split chunks share window 0's time base: offsets stay in-window
    for w in out[:3]:
        t = np.asarray(w.t_off)[np.asarray(w.kind) != 0]
        assert (t >= 0).all() and (t < CFG.window_us).all()


def test_replay_out_of_range_start_raises(trace_dir, tmp_path):
    out = str(tmp_path / "s.npz")
    precompile_trace(CFG, trace_dir, out, N, start_us=START, shard_windows=8)
    # eager: the error surfaces at call time, on the caller's thread, not
    # on the first next() inside a prefetcher
    with pytest.raises(ValueError, match="outside the stack"):
        replay_windows(out, start_window=N)
    with pytest.raises(ValueError, match=">= 0"):
        replay_windows(out, start_window=-1)
    # in range, it still streams
    got = sum(b.kind.shape[0] for b in replay_windows(out,
                                                      start_window=N - 3))
    assert got == 3


def test_cli_out_of_range_start_window_errors(trace_dir, tmp_path, capsys):
    """The whatif CLI refuses a past-the-end --start-window with an
    argparse error, not an empty sweep."""
    from repro_torch.launch import whatif
    out = str(tmp_path / "s.npz")
    precompile_trace(CFG, trace_dir, out, N, start_us=START, shard_windows=8)
    with pytest.raises(SystemExit) as e:
        whatif.main(["--replay", out, "--schedulers", "greedy",
                     "--start-window", str(N + 5), "--device", "cpu"])
    assert e.value.code == 2
    assert f"outside the stack's [0, {N})" in capsys.readouterr().err


def test_parse_stats_roundtrip(trace_dir, tmp_path):
    out = str(tmp_path / "s.npz")
    precompile_trace(CFG, trace_dir, out, N, start_us=START, shard_windows=8)
    stats = stack_parse_stats(out)
    assert stats is not None and stats["rows"] > 0
    parser = GCDParser(CFG, trace_dir)
    list(parser.packed_windows(N, start_us=START))
    for k, v in stats.items():
        assert v == getattr(parser.stats, k), k


def test_overflow_warning_surfaces_dropped_rows():
    assert overflow_warning(None) is None
    assert overflow_warning(ParseStats()) is None
    assert overflow_warning({"slot_overflow": 0, "attr_overflow": 0}) is None
    w = overflow_warning({"slot_overflow": 7, "attr_overflow": 0})
    assert w is not None and "7" in w and "slot_overflow" in w
    w = overflow_warning(ParseStats(attr_overflow=3))
    assert w is not None and "attr_overflow" in w


def test_overflowing_parse_persists_nonzero_stats(tmp_path):
    """A config too small for the trace leaves a visible trail in the stack
    metadata, not just in the parsing process's memory."""
    tiny = dataclasses.replace(CFG, max_nodes=4, max_tasks=16)
    d = str(tmp_path / "trace")
    generate_trace(d, n_machines=16, n_jobs=40, horizon_windows=10, seed=5,
                   usage_period_us=10_000_000)
    out = str(tmp_path / "s.npz")
    precompile_trace(tiny, d, out, 10, start_us=START, shard_windows=4)
    stats = stack_parse_stats(out)
    assert stats["slot_overflow"] > 0
    assert overflow_warning(stats) is not None


def test_fork_point_store_bounded():
    from repro_torch.scenarios.spec import ScenarioSpec
    from repro_torch.service.forkpoint import ForkPointStore

    specs = [ScenarioSpec(name="t", scheduler="greedy")]
    state = type(init_state(CFG, "cpu"))(
        *[x[None] for x in init_state(CFG, "cpu")])

    with pytest.raises(ValueError):
        ForkPointStore(max_points=0)

    store = ForkPointStore(max_points=3)
    for w in (32, 64, 96, 128, 160):
        store.add(w, state, specs)
        assert len(store.windows) <= 3
    # oldest evicted first; the frontier survives
    assert store.windows == [96, 128, 160]
    with pytest.raises(KeyError):
        store.get(32)
    assert store.nearest_at_or_before(100) == 96
    assert torch.equal(store.lane_state(160, [0]).task_node, state.task_node)

    unbounded = ForkPointStore()
    for w in (32, 64, 96, 128, 160):
        unbounded.add(w, state, specs)
    assert len(unbounded.windows) == 5
