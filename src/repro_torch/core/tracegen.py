"""Synthetic GCD-schema trace generator.

The real 2011 Google trace (191 GB, gs://clusterdata-2011-2) is not
redistributable/downloadable in this offline container, so this module
generates traces in the **exact GCD v2 CSV schema** with the statistical
shape the paper (and refs [15, 16, 27]) describe:

* non-cyclical Poisson-burst job arrivals; heavy-tailed tasks-per-job;
* lognormal durations; priorities 0-11 with gmail-like latency-sensitive tail;
* requested resources ~ lognormal, **actual usage a small Beta fraction of the
  request** (users waste up to 98% of requests — paper §I);
* secondary stats: CPI ~ N(1.5, .4), MAI, page cache, disk I/O time;
* node churn (add/remove/update during the trace — paper §III bullet 4);
* obfuscated attribute key/values + task constraints with {=, ≠, <, >} ops;
* the 10-minute (600 s) time shift before which pre-existing machines are
  declared.

Output: the six GCD tables as CSVs (optionally .gz) so the *parser* is
exercised end-to-end, plus a ground-truth summary used by tests.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


SHIFT_US = 600_000_000               # GCD's 10-minute shift
USAGE_PERIOD_US = 300_000_000        # GCD measurement period (5 min)


@dataclasses.dataclass
class TraceSummary:
    n_machines: int
    n_jobs: int
    n_tasks: int
    n_task_events: int
    n_usage_records: int
    n_machine_events: int
    horizon_us: int


def _open(path: str, gz: bool):
    return gzip.open(path + ".gz", "wt") if gz else open(path, "w")


def generate_trace(out_dir: str, *, n_machines: int = 128, n_jobs: int = 200,
                   horizon_windows: int = 120, window_us: int = 5_000_000,
                   seed: int = 0, gz: bool = False,
                   churn_prob: float = 0.002,
                   constraint_prob: float = 0.25,
                   usage_period_us: int = USAGE_PERIOD_US) -> TraceSummary:
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    horizon_us = SHIFT_US + horizon_windows * window_us

    # ---- machines (mostly declared at t=0, before the shift) ----
    plat_caps = np.array([[0.25, 0.25], [0.5, 0.5], [0.5, 0.25],
                          [1.0, 1.0], [1.0, 0.5]])
    m_cap = plat_caps[rng.integers(0, len(plat_caps), n_machines)]
    machine_rows: List[Tuple] = []
    attr_rows: List[Tuple] = []
    n_machine_events = 0
    for m in range(n_machines):
        machine_rows.append((0, 10_000_000 + m, 0, f"platform_{m % 3}",
                             m_cap[m, 0], m_cap[m, 1]))
        n_machine_events += 1
        for k in rng.choice(12, size=rng.integers(1, 5), replace=False):
            attr_rows.append((0, 10_000_000 + m, f"attr_{k}",
                              int(rng.integers(1, 4)), 0))
    # churn: remove + re-add + capacity updates during the trace
    for w in range(horizon_windows):
        t = SHIFT_US + w * window_us
        for m in range(n_machines):
            if rng.random() < churn_prob:
                kind = rng.integers(0, 3)
                if kind == 0:       # REMOVE
                    machine_rows.append((t, 10_000_000 + m, 1, "", "", ""))
                elif kind == 1:     # ADD back
                    machine_rows.append((t + 1, 10_000_000 + m, 0,
                                         f"platform_{m % 3}",
                                         m_cap[m, 0], m_cap[m, 1]))
                else:               # UPDATE capacity
                    machine_rows.append((t, 10_000_000 + m, 2,
                                         f"platform_{m % 3}",
                                         m_cap[m, 0] * rng.choice([0.5, 1.0, 2.0]),
                                         m_cap[m, 1]))
                n_machine_events += 1

    # ---- jobs / tasks ----
    task_rows: List[Tuple] = []
    cons_rows: List[Tuple] = []
    usage_rows: List[Tuple] = []
    n_tasks = 0
    for j in range(n_jobs):
        job_id = 6_000_000_000 + j
        arrive_w = int(rng.integers(0, max(horizon_windows - 4, 1)))
        t_submit = SHIFT_US + arrive_w * window_us + int(rng.integers(0, window_us))
        n_t = min(1 + int(rng.pareto(1.2)), 64)          # heavy tail
        sched_class = int(rng.integers(0, 4))
        prio = int(rng.choice([0, 1, 2, 4, 8, 9, 10, 11],
                              p=[.25, .2, .15, .1, .1, .08, .07, .05]))
        for ti in range(n_t):
            n_tasks += 1
            cpu_req = float(np.clip(rng.lognormal(-3.2, 0.8), 0.001, 0.5))
            ram_req = float(np.clip(rng.lognormal(-3.5, 0.9), 0.001, 0.5))
            disk_req = float(np.clip(rng.lognormal(-6.0, 1.0), 1e-5, 0.2))
            dur_w = max(1, int(rng.lognormal(2.2, 1.1)))
            t0 = t_submit + int(rng.integers(0, 1_000_000))
            task_rows.append((t0, "", job_id, ti, "", 0, f"user_{j % 17}",
                              sched_class, prio, cpu_req, ram_req, disk_req, 0))
            # end event: FINISH (4) mostly; EVICT(2)/FAIL(3)/KILL(5) minority —
            # "significant parts of the tasks were killed by the native system"
            end_kind = int(rng.choice([4, 2, 3, 5], p=[.62, .15, .08, .15]))
            t_end = t0 + dur_w * window_us + int(rng.integers(0, window_us))
            if t_end < horizon_us:
                task_rows.append((t_end, "", job_id, ti, "", end_kind,
                                  f"user_{j % 17}", sched_class, prio,
                                  cpu_req, ram_req, disk_req, 0))
            # occasional requirement update while alive (UPDATE_RUNNING=8)
            if rng.random() < 0.05:
                t_up = t0 + int(rng.integers(1, max(dur_w, 2))) * window_us
                if t_up < min(t_end, horizon_us):
                    task_rows.append((t_up, "", job_id, ti, "", 8,
                                      f"user_{j % 17}", sched_class, prio,
                                      cpu_req * 1.5, ram_req, disk_req, 0))
            # constraints
            if rng.random() < constraint_prob:
                for _ in range(rng.integers(1, 3)):
                    cons_rows.append((t0, job_id, ti, int(rng.integers(0, 4)),
                                      f"attr_{int(rng.integers(0, 12))}",
                                      int(rng.integers(0, 4))))
            # usage samples every 5-minute GCD period while alive
            frac = float(np.clip(rng.beta(1.3, 8.0), 0.01, 1.0))  # ~98% waste tail
            t_u = t0 + usage_period_us
            while t_u < min(t_end, horizon_us):
                cpu = cpu_req * frac * float(np.clip(rng.normal(1, .25), .05, 2))
                ram = ram_req * frac
                usage_rows.append((
                    t_u - usage_period_us, t_u, job_id, ti, "",
                    cpu, ram, ram * 1.1, ram * 0.05, ram * 0.15, ram * 1.2,
                    float(np.clip(rng.lognormal(-4, 1), 0, .5)),   # disk io time
                    disk_req * frac,
                    cpu * 1.4, 0.01,
                    float(np.clip(rng.normal(1.5, .4), .5, 4)),    # CPI
                    float(np.clip(rng.normal(.03, .01), .001, .2)),  # MAI
                    1.0, 1, cpu))
                t_u += usage_period_us

    # ---- write tables (GCD v2 column order) ----
    def write(name: str, rows: List[Tuple], tcol: int = 0):
        rows = sorted(rows, key=lambda r: r[tcol])
        with _open(os.path.join(out_dir, name), gz) as f:
            for r in rows:
                f.write(",".join("" if v == "" else str(v) for v in r) + "\n")

    write("machine_events-00000-of-00001.csv", machine_rows)
    write("machine_attributes-00000-of-00001.csv", attr_rows)
    write("task_events-00000-of-00001.csv", task_rows)
    write("task_constraints-00000-of-00001.csv", cons_rows)
    write("task_usage-00000-of-00001.csv", usage_rows)
    # job_events (subset — the engine tracks jobs through tasks)
    job_rows = sorted({(r[0], "", r[2], 0, f"user", 0, f"job_{r[2]}", "") for
                       r in task_rows if r[5] == 0}, key=lambda r: r[0])
    write("job_events-00000-of-00001.csv", list(job_rows))

    return TraceSummary(
        n_machines=n_machines, n_jobs=n_jobs, n_tasks=n_tasks,
        n_task_events=len(task_rows), n_usage_records=len(usage_rows),
        n_machine_events=n_machine_events, horizon_us=horizon_us)


# ---------------------------------------------------------------------------
# Paper-scale mode: cell A geometry (12.5K nodes, month-long horizon)
# ---------------------------------------------------------------------------

PAPER_CELL_MACHINES = 12_500         # cell A node count (paper §II)
PAPER_JOBS_PER_HOUR = 550            # cell A's ~order-of-magnitude admit rate
MONTH_WINDOWS = 29 * 86_400 // 5     # the trace's 29 days of 5-second windows


def generate_paper_scale_trace(out_dir: str, *,
                               horizon_windows: Optional[int] = None,
                               n_machines: int = PAPER_CELL_MACHINES,
                               jobs_per_hour: int = PAPER_JOBS_PER_HOUR,
                               window_us: int = 5_000_000, seed: int = 0,
                               gz: bool = True, **kw) -> TraceSummary:
    """GCD-schema synthesis at the paper's cell-A geometry.

    The full month is ``MONTH_WINDOWS`` (501,120 windows); pass a smaller ``horizon_windows`` for a
    time-sliced cut of the *same* cell — the node fleet and arrival
    intensity stay at paper scale, only the horizon shrinks, so
    ingestion benchmarks on a slice extrapolate linearly to the month.
    Job count derives from the admit rate so callers can't accidentally
    decouple horizon and load.
    """
    if horizon_windows is None:
        horizon_windows = MONTH_WINDOWS
    sim_hours = horizon_windows * window_us / 1e6 / 3600.0
    n_jobs = max(1, int(round(sim_hours * jobs_per_hour)))
    return generate_trace(out_dir, n_machines=n_machines, n_jobs=n_jobs,
                          horizon_windows=horizon_windows,
                          window_us=window_us, seed=seed, gz=gz, **kw)
