"""Shared trace-parser machinery + the trace-family registry.

Every trace family (Google Cluster Data, Alibaba OpenB, ...) streams its own
on-disk format into the ONE host-event contract the engine understands:
:class:`~repro_torch.core.events.HostEvent` rows in merged timestamp order, bucketed
into :class:`~repro_torch.core.events.EventWindow` tensors by the machinery here.
A family subclasses :class:`TraceParser`, implements :meth:`TraceParser.events`
and registers itself under a name — ``simulate``/``whatif``/``precompile``
select a family with ``--trace-family`` and never see format differences.

The id->slot resolution helpers (:class:`SlotAllocator`, :class:`AttrVocab`)
and the anomaly counters (:class:`ParseStats`) live here too: the paper's
§VIII "cope with data anomalies" requirement is format-independent.
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import os
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Type

from repro_torch.config import SimConfig
from repro_torch.core.events import EventWindow, HostEvent, pack_window


@dataclasses.dataclass
class ParseStats:
    rows: int = 0
    bad_rows: int = 0
    usage_unknown_task: int = 0
    dup_terminal: int = 0
    constraints_dead_task: int = 0
    slot_overflow: int = 0
    attr_overflow: int = 0


class SlotAllocator:
    """Dense id <-> slot resolution with a free list (host side)."""

    def __init__(self, capacity: int, stats: ParseStats):
        self.capacity = capacity
        self.map: Dict[Tuple, int] = {}
        self.free = list(range(capacity - 1, -1, -1))
        self.stats = stats

    def acquire(self, key) -> Optional[int]:
        s = self.map.get(key)
        if s is not None:
            return s
        if not self.free:
            self.stats.slot_overflow += 1
            return None
        s = self.free.pop()
        self.map[key] = s
        return s

    def lookup(self, key) -> Optional[int]:
        return self.map.get(key)

    def release(self, key) -> Optional[int]:
        s = self.map.pop(key, None)
        if s is not None:
            self.free.append(s)
        return s


class AttrVocab:
    """Obfuscated attribute-name -> column-slot mapping (host side).

    Hashes use crc32, NOT Python's ``hash`` — str hashing is randomised per
    process (PYTHONHASHSEED), which made re-runs of the same trace simulate
    slightly different worlds whenever attribute strings were non-numeric.
    """

    def __init__(self, n_slots: int, stats: ParseStats):
        self.n = n_slots
        self.map: Dict[str, int] = {}
        self.stats = stats

    def slot(self, name: str) -> int:
        s = self.map.get(name)
        if s is None:
            if len(self.map) >= self.n:
                self.stats.attr_overflow += 1
                s = zlib.crc32(name.encode()) % self.n
            else:
                s = len(self.map)
            self.map[name] = s
        return s

    @staticmethod
    def value(v: str) -> int:
        if v == "" or v is None:
            return 1
        try:
            return int(v) & 0x7FFFFFFF
        except ValueError:
            return (zlib.crc32(v.encode()) & 0x7FFFFF) + 1


def open_maybe_gz(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def iter_csv_table(trace_dir: str, table: str,
                   pattern: str = "{table}-*.csv*") -> Iterator[List[str]]:
    """Stream the comma-split rows of every shard of ``table``, in shard
    order (trace families shard time-sorted, so concatenation stays sorted)."""
    paths = sorted(glob.glob(os.path.join(trace_dir,
                                          pattern.format(table=table))))
    for p in paths:
        with open_maybe_gz(p) as f:
            for line in f:
                yield line.rstrip("\n").split(",")


def field_float(row: List[str], i: int, default: float = 0.0) -> float:
    try:
        return float(row[i]) if i < len(row) and row[i] != "" else default
    except ValueError:
        return default


def field_int(row: List[str], i: int, default: int = 0) -> int:
    try:
        return int(row[i]) if i < len(row) and row[i] != "" else default
    except ValueError:
        return default


class TraceParser:
    """Base class: merged HostEvent stream -> fixed-shape EventWindows.

    Subclasses implement :meth:`events` (HostEvents in non-decreasing
    ``time_us`` order, ids already resolved to dense slots through the
    allocators below) and inherit the windowing/packing machinery — so the
    window geometry, injection slot-pool reservation and overlong-window
    splitting behave identically across trace families.
    """

    #: registry name, set by :func:`register_parser`
    family: str = ""

    def __init__(self, cfg: SimConfig, trace_dir: str):
        self.cfg = cfg
        self.dir = trace_dir
        self.stats = ParseStats()
        # real tasks only get slots below the injection pool, so on-device
        # synthesised SUBMITs (cfg.inject_slots) never collide with trace ids
        self.tasks = SlotAllocator(cfg.real_task_slots, self.stats)
        self.nodes = SlotAllocator(cfg.max_nodes, self.stats)
        self.attrs = AttrVocab(cfg.n_attr_slots, self.stats)

    # --- family-specific: the merged, slot-resolved event stream ---

    def events(self) -> Iterator[HostEvent]:
        raise NotImplementedError

    # --- shared: stream -> windows ---

    def windows(self, start_us: int = 0
                ) -> Iterator[Tuple[int, List[HostEvent]]]:
        """Bucket the merged stream into consecutive window indices."""
        cur: List[HostEvent] = []
        cur_w = 0
        for ev in self.events():
            w = max((ev.time_us - start_us), 0) // self.cfg.window_us
            while w > cur_w:
                yield cur_w, cur
                cur, cur_w = [], cur_w + 1
            cur.append(ev)
        yield cur_w, cur

    def packed_windows(self, n_windows: int, start_us: int = 0
                       ) -> Iterator[EventWindow]:
        """Fixed-shape EventWindows, splitting overlong windows (the E bound).

        Every split chunk of one overlong trace window carries that window's
        ``window_idx`` (their t_off stay relative to the same window base),
        so the emitted-*chunk* count can run ahead of the trace-*window*
        index. Tail gap-fill windows therefore continue from the true next
        trace-window index, NOT the chunk count — padding with the chunk
        count gave gap windows discontinuous indices after any split.
        """
        gen = self.windows(start_us)
        produced = 0
        next_w = 0                  # true next trace-window index
        for w_idx, evs in gen:
            if produced >= n_windows:
                break
            next_w = w_idx + 1
            E = self.cfg.events_per_window
            chunks = [evs[i:i + E] for i in range(0, max(len(evs), 1), E)]
            for ch in chunks:
                if produced >= n_windows:
                    break
                yield pack_window(self.cfg, ch, w_idx)
                produced += 1
        while produced < n_windows:
            yield pack_window(self.cfg, [], next_w)
            next_w += 1
            produced += 1


# ---------------------------------------------------------------------------
# Trace-family registry
# ---------------------------------------------------------------------------

PARSERS: Dict[str, Type[TraceParser]] = {}


def register_parser(name: str) -> Callable[[Type[TraceParser]],
                                           Type[TraceParser]]:
    """Class decorator: register a TraceParser under a family name."""
    def deco(cls: Type[TraceParser]) -> Type[TraceParser]:
        if not issubclass(cls, TraceParser):
            raise TypeError(f"{cls!r} is not a TraceParser")
        cls.family = name
        PARSERS[name] = cls
        return cls
    return deco


def get_parser(name: str) -> Type[TraceParser]:
    """Resolve a trace-family name to its parser class."""
    # built-in families register on import; plugins must have imported
    import repro_torch.parsers  # noqa: F401  (populates PARSERS)
    if name not in PARSERS:
        raise KeyError(f"unknown trace family {name!r}; "
                       f"known: {sorted(PARSERS)}")
    return PARSERS[name]


def describe_parsers() -> str:
    import repro_torch.parsers  # noqa: F401
    lines = ["trace families:"]
    for name in sorted(PARSERS):
        doc = (PARSERS[name].__doc__ or "").strip().splitlines()[0]
        lines.append(f"  {name:10s} {doc}")
    return "\n".join(lines)

