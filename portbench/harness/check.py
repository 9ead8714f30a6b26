"""The comparison that decides ``correct``: what the program's timed path
produced against the plain reference (``portbench/reference``), each
number beside its limit.

Two kinds of number are compared:

* ``*_int_mismatch``: how many integer entries differ (counts, task
  states, placements, node ids, counters). Decisions and counts are exact
  in the simulator, so the limit is 0.
* ``*_float_gap``: the widest gap of a float entry, as a share of the
  largest magnitude its column holds in the reference (the column's scale,
  so an entry near 0 does not blow the ratio up). Sums over thousands of
  nodes or tasks are taken in another order by the program's kernels, so
  the gap is rounding; the limit sits between what sound runs read and
  what the bfloat16 control reads (``PERF.md`` gives both readings).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

# limits set from the readings in PERF.md: sound runs over 12 seeds a cell
# read float gaps of 2.7e-7 to 5.1e-7 (0 at the fork point), the bfloat16
# control on 3 seeds a cell 0.0179 and more; integer entries are exact
LIMITS = {
    "int_mismatch": 0,
    "float_gap": 1e-4,
}


def gap(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
        keys: Iterable[str]) -> Tuple[int, float]:
    """(integer entries that differ, widest relative float gap) over
    ``keys`` present in both."""
    mism, worst = 0, 0.0
    for k in keys:
        p, r = np.asarray(prog[k]), np.asarray(ref[k])
        if p.shape != r.shape:
            mism += max(p.size, r.size)
            continue
        if r.dtype.kind in "biu":
            mism += int(np.count_nonzero(p != r))
            continue
        p64, r64 = p.astype(np.float64), r.astype(np.float64)
        bad = ~(np.isfinite(p64) == np.isfinite(r64))
        if bad.any():
            worst = float("inf")
            continue
        fin = np.isfinite(r64)
        if not fin.any():
            continue
        scale = max(float(np.abs(r64[fin]).max()), 1e-30)
        d = np.abs(p64[fin] - r64[fin])
        if d.size:
            worst = max(worst, float(d.max()) / scale)
    return mism, worst


class Verdict:
    """Numbers compared, each with its limit, in the order added."""

    def __init__(self):
        self.numbers: Dict[str, Tuple[float, float]] = {}

    def add(self, name: str, value: float, kind: str):
        self.numbers[name] = (value, LIMITS[kind])

    def add_pair(self, prefix: str, mism: int, worst: float):
        self.add(prefix + "_int_mismatch", mism, "int_mismatch")
        self.add(prefix + "_float_gap", worst, "float_gap")

    def fail(self, name: str, value: float, limit: float):
        self.numbers[name] = (value, limit)

    @property
    def correct(self) -> bool:
        return bool(self.numbers) and all(v <= lim for v, lim in
                                          self.numbers.values())

    def as_json(self) -> dict:
        return {k: {"value": v, "limit": lim}
                for k, (v, lim) in self.numbers.items()}

    def lines(self):
        return [f"check {k}: {v!r} (limit {lim!r})"
                for k, (v, lim) in self.numbers.items()]
