"""Process-wide model-execution flags.

A copy of ``repro.models.runtime_flags``. UNROLL: per-scan-kind unroll
factors for *inner* scans (SSD chunk scan, query-chunked attention). In
the reference the dry-run's cost probes use them for unroll-differencing,
because XLA's cost analysis counts a while-loop body once. The port's
inner scans are Python loops that dispatch every chunk, and its planner
counts every op that runs (``launch/plan_cost.py``), so an unroll factor
changes no value and no count; the flags are kept so that code written
against the reference's interface runs unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Dict

UNROLL: Dict[str, int] = {}


@contextlib.contextmanager
def scan_unroll(**kinds: int):
    """e.g. ``with scan_unroll(ssd=4):`` — unroll SSD chunk scans 4x."""
    global UNROLL
    old = dict(UNROLL)
    UNROLL.update(kinds)
    try:
        yield
    finally:
        UNROLL = old


def inner_unroll(kind: str, length: int) -> int:
    """Unroll factor for an inner scan of `length` iterations."""
    return max(1, min(UNROLL.get(kind, 1), length))
