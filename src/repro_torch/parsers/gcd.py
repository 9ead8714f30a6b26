"""Google Cluster Data (v2 schema) streaming parser.

Implements the published format+schema [Reiss/Wilkes/Hellerstein 2013] for the
six tables, streaming CSV (or .gz) shards, heap-merging the independent row
sources by timestamp (the paper's five parser actors each own a table), and
THEN resolving 64-bit GCD ids to dense device slots — resolution must happen
in merged timestamp order, not per-table read order, or usage rows would be
resolved before the SUBMIT that creates their task.

Anomaly handling (paper §II lists the known GCD inconsistencies, §VIII
demands the simulator "cope with data anomalies"): missing fields parse to
defaults, usage rows for unknown tasks are dropped, duplicate terminal events
are idempotent, constraint rows for dead tasks are ignored — each counted in
``ParseStats``.

The windowing/packing machinery (and the id->slot allocators) live in
``repro_torch.parsers.base`` and are shared with the other trace families.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.config import SimConfig
from repro_torch.core.events import (EventKind, HostEvent, GCD_TASK_ACTION, OP_EQ,
                               OP_GT, OP_LT, OP_NE, REMOVE_REASON_EVICT)
from repro_torch.parsers.base import (AttrVocab, ParseStats, SlotAllocator,
                                TraceParser, field_float as _f,
                                field_int as _i, iter_csv_table,
                                open_maybe_gz as _open, register_parser)

# GCD constraint op codes -> ours
_GCD_OP = {0: OP_EQ, 1: OP_NE, 2: OP_LT, 3: OP_GT}

# merge priority per table (stable ordering for equal timestamps: machines
# before attributes before task lifecycle before constraints before usage)
_T_MACHINE, _T_MATTR, _T_TASK, _T_CONS, _T_USAGE = 0, 1, 2, 3, 4

TABLES = ("machine_events", "machine_attributes", "task_events",
          "task_constraints", "task_usage", "job_events")


def _iter_table(trace_dir: str, table: str) -> Iterator[List[str]]:
    return iter_csv_table(trace_dir, table)


@register_parser("gcd")
class GCDParser(TraceParser):
    """Google Cluster Data v2 CSV directory (six sharded tables).

    Stage 1 (per-table generators ≈ the paper's parser actors): raw CSV rows
    tagged ``(timestamp, table_priority, row)`` — stateless, so lazy
    prefetching by the merge is harmless.
    Stage 2 (merge): heapq.merge by (timestamp, priority).
    Stage 3 (resolve): stateful id->slot / attr-vocab resolution **in merged
    order**, producing HostEvents.
    """

    def __init__(self, cfg: SimConfig, trace_dir: str):
        super().__init__(cfg, trace_dir)
        self.jobs: Dict[int, int] = {}
        self._alive: Dict[Tuple, bool] = {}
        self._cons: Dict[Tuple, List] = {}

    @staticmethod
    def default_start_us(cfg: SimConfig) -> int:
        # pre-existing machines are declared during GCD's 10-minute shift;
        # runs start one window before it (see core/tracegen.py)
        from repro_torch.core.tracegen import SHIFT_US
        return SHIFT_US - cfg.window_us

    # --- stage 1: raw tagged rows (stateless) ---

    def _raw(self, table: str, prio: int, tcol: int = 0
             ) -> Iterator[Tuple[int, int, str, List[str]]]:
        for row in _iter_table(self.dir, table):
            yield (_i(row, tcol), prio, table, row)

    # --- stage 3: stateful resolution ---

    def _resolve(self, table: str, row: List[str]) -> Optional[HostEvent]:
        self.stats.rows += 1
        if table == "machine_events":
            t, mid, etype = _i(row, 0), _i(row, 1), _i(row, 2)
            if etype in (0, 2):
                slot = self.nodes.acquire(mid)
                if slot is None:
                    return None
                kind = (EventKind.ADD_NODE if etype == 0
                        else EventKind.UPDATE_NODE_RESOURCES)
                return HostEvent(t, kind, slot, a=(_f(row, 4), _f(row, 5), 1.0))
            slot = self.nodes.lookup(mid)
            if slot is None:
                return None
            return HostEvent(t, EventKind.REMOVE_NODE, slot)

        if table == "machine_attributes":
            t, mid = _i(row, 0), _i(row, 1)
            slot = self.nodes.acquire(mid)
            if slot is None:
                return None
            name = row[2] if len(row) > 2 else ""
            val = row[3] if len(row) > 3 else ""
            deleted = _i(row, 4)
            kind = (EventKind.REMOVE_NODE_ATTR if deleted
                    else EventKind.ADD_NODE_ATTR)
            return HostEvent(t, kind, slot, attr_idx=self.attrs.slot(name),
                             attr_val=AttrVocab.value(val))

        if table == "task_events":
            t = _i(row, 0)
            key = (_i(row, 2), _i(row, 3))
            action = _i(row, 5)
            kind = GCD_TASK_ACTION.get(action)
            if kind is None:          # SCHEDULE — paper Table I: ignore
                return None
            prio = _i(row, 8)
            req = (_f(row, 9), _f(row, 10), _f(row, 11))
            if kind == EventKind.ADD_TASK:
                if self._alive.get(key):
                    kind = EventKind.UPDATE_TASK_REQUIRED
                    slot = self.tasks.lookup(key)
                    if slot is None:
                        return None
                    return HostEvent(t, kind, slot, a=req, prio=prio)
                slot = self.tasks.acquire(key)
                if slot is None:
                    return None
                self._alive[key] = True
                jid = self.jobs.setdefault(key[0], len(self.jobs))
                return HostEvent(t, kind, slot, a=req, prio=prio, job=jid,
                                 constraints=self._cons.get(key))
            if kind == EventKind.REMOVE_TASK:
                if not self._alive.get(key):
                    self.stats.dup_terminal += 1
                    return None
                slot = self.tasks.release(key)
                self._alive[key] = False
                self._cons.pop(key, None)
                if slot is None:
                    return None
                reason = float(REMOVE_REASON_EVICT) if action == 2 else 0.0
                return HostEvent(t, kind, slot, a=(reason, 0.0, 0.0))
            slot = self.tasks.lookup(key)     # UPDATE_PENDING / UPDATE_RUNNING
            if slot is None:
                return None
            return HostEvent(t, kind, slot, a=req, prio=prio)

        if table == "task_constraints":
            t = _i(row, 0)
            key = (_i(row, 1), _i(row, 2))
            op = _GCD_OP.get(_i(row, 3), OP_EQ)
            attr = self.attrs.slot(row[4] if len(row) > 4 else "")
            val = AttrVocab.value(row[5] if len(row) > 5 else "")
            cons = self._cons.setdefault(key, [])
            if len(cons) < self.cfg.max_constraints:
                cons.append((attr, op, val))
            slot = self.tasks.lookup(key)
            if slot is None:
                if self._alive.get(key) is False:
                    self.stats.constraints_dead_task += 1
                return None                   # attaches at ADD time instead
            return HostEvent(t, EventKind.UPDATE_TASK_CONSTRAINTS, slot,
                             constraints=list(cons))

        if table == "task_usage":
            t_end = _i(row, 1)
            key = (_i(row, 2), _i(row, 3))
            slot = self.tasks.lookup(key)
            if slot is None:
                self.stats.usage_unknown_task += 1
                return None
            u = (_f(row, 5), _f(row, 6), _f(row, 7), _f(row, 9),
                 _f(row, 11), _f(row, 12), _f(row, 15), _f(row, 16))
            return HostEvent(t_end, EventKind.UPDATE_TASK_USED, slot, u=u)

        self.stats.bad_rows += 1
        return None

    # --- merged stream ---

    def events(self) -> Iterator[HostEvent]:
        sources = [
            self._raw("machine_events", _T_MACHINE),
            self._raw("machine_attributes", _T_MATTR),
            self._raw("task_events", _T_TASK),
            self._raw("task_constraints", _T_CONS),
            self._raw("task_usage", _T_USAGE, tcol=1),  # keyed by end_time
        ]
        for t, prio, table, row in heapq.merge(*sources,
                                               key=lambda x: (x[0], x[1])):
            ev = self._resolve(table, row)
            if ev is not None:
                yield ev
