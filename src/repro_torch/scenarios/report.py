"""Per-scenario comparative metrics — the deliverable of a what-if study.

Takes the (W, B, ...) stats frame a ScenarioFleet accumulates and reduces it
to per-scenario rows (final counters, mean utilisation, balance quality) plus
deltas against a designated baseline scenario, as both a JSON-able dict
(curves included, for plotting) and a plain-text table. numpy only: a copy
of the reference's ``scenarios/report.py``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def _col(frame: Dict[str, np.ndarray], key: str, b: int) -> np.ndarray:
    """Scenario b's (W,) or (W, ...) series for a stats key."""
    return np.asarray(frame[key])[:, b]


def scenario_report(names: Sequence[str], frame: Dict[str, np.ndarray],
                    schedulers: Optional[Sequence[str]] = None,
                    baseline: int = 0) -> dict:
    """Reduce a (W, B, ...) stats frame to per-scenario comparative rows.

    Counter metrics (placements/completions/evictions) take their final
    cumulative value; occupancy metrics (pending, utilisation) also report a
    trace-wide mean. Deltas are vs. the ``baseline`` scenario index.
    """
    if not frame:
        return {"baseline": baseline, "scenarios": []}
    B = len(names)
    rows: List[dict] = []
    for b in range(B):
        cpu_res = _col(frame, "reserved_frac", b)[:, 0]
        cpu_used = _col(frame, "used_frac", b)[:, 0]
        rows.append({
            "scenario": names[b],
            "scheduler": schedulers[b] if schedulers else None,
            "placements": int(_col(frame, "placements", b)[-1]),
            "completions": int(_col(frame, "completions", b)[-1]),
            "evictions": int(_col(frame, "evictions", b)[-1]),
            # per-window counts, so the cumulative total is the sum
            "injected": (int(_col(frame, "injected_arrivals", b).sum())
                         if "injected_arrivals" in frame else 0),
            "pending_final": int(_col(frame, "n_pending", b)[-1]),
            "pending_mean": float(_col(frame, "n_pending", b).mean()),
            "running_final": int(_col(frame, "n_running", b)[-1]),
            "nodes_final": int(_col(frame, "n_nodes", b)[-1]),
            "cpu_reserved_frac_mean": float(cpu_res.mean()),
            "cpu_used_frac_mean": float(cpu_used.mean()),
            "util_balance_var_final": float(
                _col(frame, "util_balance_var", b)[-1]),
        })
    base = rows[baseline]
    for row in rows:
        row["d_placements"] = row["placements"] - base["placements"]
        row["d_completions"] = row["completions"] - base["completions"]
        row["d_evictions"] = row["evictions"] - base["evictions"]
        row["d_pending_mean"] = row["pending_mean"] - base["pending_mean"]
        row["d_cpu_reserved_frac_mean"] = (row["cpu_reserved_frac_mean"]
                                           - base["cpu_reserved_frac_mean"])
    curves = {
        key: np.asarray(frame[key]).T.tolist()   # (B, W) per-scenario series
        for key in ("n_pending", "n_running", "completions", "evictions")
        if key in frame
    }
    return {"baseline": baseline, "baseline_name": names[baseline],
            "scenarios": rows, "curves": curves}


_COLUMNS = (
    ("scenario", "scenario", "{}"),
    ("sched", "scheduler", "{}"),
    ("nodes", "nodes_final", "{}"),
    ("placed", "placements", "{}"),
    ("done", "completions", "{}"),
    ("evict", "evictions", "{}"),
    ("inj", "injected", "{}"),
    ("pend", "pending_final", "{}"),
    ("cpu_res", "cpu_reserved_frac_mean", "{:.3f}"),
    ("cpu_use", "cpu_used_frac_mean", "{:.3f}"),
    ("bal_var", "util_balance_var_final", "{:.2e}"),
    ("Δplaced", "d_placements", "{:+d}"),
    ("Δpend", "d_pending_mean", "{:+.1f}"),
)


def format_table(report: dict) -> str:
    """Fixed-width text table of a scenario_report (baseline marked *)."""
    rows = report["scenarios"]
    if not rows:
        return "(no scenarios)"
    cells = [[h for h, _, _ in _COLUMNS]]
    for i, row in enumerate(rows):
        line = []
        for _, key, fmt in _COLUMNS:
            v = row.get(key)
            line.append("-" if v is None else fmt.format(v))
        mark = "*" if i == report["baseline"] else " "
        line[0] = mark + line[0]
        cells.append(line)
    widths = [max(len(r[c]) for r in cells) for c in range(len(_COLUMNS))]
    out = []
    for r, line in enumerate(cells):
        out.append("  ".join(s.rjust(w) if c else s.ljust(w + 1)
                             for c, (s, w) in enumerate(zip(line, widths))))
        if r == 0:
            out.append("-" * len(out[0]))
    return "\n".join(out)


def to_json(report: dict, path: Optional[str] = None) -> str:
    s = json.dumps(report, indent=1)
    if path:
        with open(path, "w") as f:
            f.write(s)
    return s
