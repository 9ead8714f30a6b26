"""Simulation monitor — the paper's Fig. 5 GUI module as a detachable,
terminal-friendly reporter (the paper promises "a fully detachable and
stand-alone monitor application will be created in the future"; this is it:
it reads snapshots, so it can run in a different process/machine from the
simulation server).

A state on any device is moved to the host once; the text is then built
on the host, as the reference builds it.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from repro_torch.config import SimConfig
from repro_torch.core.snapshot import load_snapshot
from repro_torch.core.state import (TASK_PENDING, TASK_RUNNING, SimState,
                                    state_to_numpy)


def _bar(frac: float, width: int = 30) -> str:
    n = int(max(0.0, min(1.0, frac)) * width)
    return "[" + "#" * n + "." * (width - n) + f"] {frac:6.1%}"


def render(state: SimState, cfg: SimConfig, windows_done: int = 0) -> str:
    s = state_to_numpy(state)
    active = s["node_active"]
    running = s["task_state"] == TASK_RUNNING
    pending = s["task_state"] == TASK_PENDING
    cap = np.where(active[:, None], s["node_total"], 0).sum(0)
    res = s["node_reserved"].sum(0)
    used = s["node_used"].sum(0)
    sim_h = windows_done * cfg.window_us / 1e6 / 3600

    lines = [
        "=" * 64,
        f" AGOCS simulation monitor      window {windows_done}"
        f"  (sim time {sim_h:7.2f} h)",
        "=" * 64,
        f" nodes active   : {int(active.sum()):>8d} / {cfg.max_nodes}",
        f" tasks running  : {int(running.sum()):>8d}",
        f" tasks pending  : {int(pending.sum()):>8d}",
        f" placements     : {int(s['placements']):>8d}",
        f" completions    : {int(s['completions']):>8d}",
        f" evictions      : {int(s['evictions']):>8d}",
        "",
        f" cpu  reserved {_bar(res[0] / max(cap[0], 1e-9))}",
        f" cpu  used     {_bar(used[0] / max(cap[0], 1e-9))}",
        f" mem  reserved {_bar(res[1] / max(cap[1], 1e-9))}",
        f" mem  used     {_bar(used[1] / max(cap[1], 1e-9))}",
        "",
    ]
    # top-5 busiest nodes (fine-grained view — the Table II differentiator)
    if active.any():
        frac = np.where(active, s["node_reserved"][:, 0] /
                        np.maximum(s["node_total"][:, 0], 1e-9), 0)
        top = np.argsort(-frac)[:5]
        lines.append(" busiest nodes (cpu reserved):")
        for n in top:
            lines.append(f"   node {int(n):>6d} {_bar(float(frac[n]), 20)}")
    lines.append("=" * 64)
    return "\n".join(lines)


def watch_snapshot(path: str, cfg_hint: Optional[SimConfig] = None,
                   interval: float = 2.0, iterations: Optional[int] = None):
    """Stand-alone mode: poll a snapshot file (of either package) and
    re-render on change. The state is loaded to the host, where it is
    rendered, so the monitor needs no card."""
    last_mtime = 0.0
    n = 0
    while iterations is None or n < iterations:
        try:
            m = os.path.getmtime(path)
        except OSError:
            time.sleep(interval)
            continue
        if m != last_mtime:
            last_mtime = m
            state, cfg, done, _extra = load_snapshot(path, device="cpu")
            print("\033[2J\033[H" + render(state, cfg, done), flush=True)
            n += 1
        time.sleep(interval)


def attach(sim, every_batches: int = 1):
    """In-process mode (paper's current design): the ``on_batch`` hook to
    pass to ``Simulation.run``; renders every ``every_batches`` batches."""
    counter = {"n": 0}

    def on_batch(s):
        counter["n"] += 1
        if counter["n"] % every_batches == 0:
            print(render(s.state, s.cfg, s.windows_done), flush=True)

    return on_batch
