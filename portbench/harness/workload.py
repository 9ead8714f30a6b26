"""The benchmark's inputs, made from ``--seed``: a Google cell's event
stream in the simulator's packed window form, and the what-if specs.

The stream follows the GCD v2 schema (clusterdata-2011-2) as the cell's
configuration file parameterises it, with the shape of the synthetic
generator the repository carries for that schema (``core/tracegen``):
machines from a small set of platforms with obfuscated attributes, jobs
of heavy-tailed size sharing a priority, lognormal requests, usage a Beta
fraction of the request sampled once a GCD measurement period, a share of
evictions among the ends, constraints {=, !=, <, >} on attributes, and
machine churn. Unlike that generator it writes the packed windows
directly (the parser's id-to-slot resolution done here: a task's slot is
taken from a free list and returned the window after it ends), it is
vectorised (no loop over machines or over tasks), and the cell starts
full, as the GCD trace does: the tasks running at its start are SUBMITted
right after the machines are declared, and their lifetimes are drawn from
the stationary residual-life distribution, so the population stays near
its starting size.

The stream has two phases. Declaration windows carry every machine, its
attributes and the starting tasks, packed at the row budget in that order.
Then each window carries machine churn, the ends due, requirement updates,
new arrivals and the usage samples due, each task's rows in distinct
windows, so a window never holds two lifecycle rows of one slot.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

# event kinds, as the simulator packs them
ADD_TASK, UPDATE_TASK_REQUIRED, UPDATE_TASK_USED, REMOVE_TASK = 1, 2, 3, 5
ADD_NODE, UPDATE_NODE_RESOURCES, ADD_NODE_ATTR, REMOVE_NODE = 6, 7, 8, 10
REMOVE_REASON_EVICT = 2.0
# within a window: node rows first, then task ends, updates, arrivals, usage
_GROUP = {REMOVE_NODE: 0, ADD_NODE: 0, UPDATE_NODE_RESOURCES: 0,
          ADD_NODE_ATTR: 1, REMOVE_TASK: 2, UPDATE_TASK_REQUIRED: 3,
          ADD_TASK: 4, UPDATE_TASK_USED: 5}


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per input stream, all from ``--seed``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64,
                                                         *stream]))


def program_seed(seed: int) -> int:
    """The simulator's own 31-bit seed (its window keys), from ``--seed``."""
    return int(rng_for(seed, 7).integers(0, 2 ** 31 - 1))


class _Rows:
    """Event rows as column arrays, concatenated once at the end."""

    def __init__(self, R: int, U: int, C: int):
        self.R, self.U, self.C = R, U, C
        self.cols: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("window", "kind", "slot", "a", "u", "prio", "job",
                            "cons", "attr_idx", "attr_val")}

    def add(self, window, kind, slot, a=None, u=None, prio=None, job=None,
            cons=None, attr_idx=None, attr_val=None):
        n = len(slot)
        z = np.zeros(n, np.int32)
        c = self.cols
        c["window"].append(np.broadcast_to(np.asarray(window, np.int64), (n,)))
        c["kind"].append(np.full(n, kind, np.int8))
        c["slot"].append(np.asarray(slot, np.int32))
        c["a"].append(np.zeros((n, self.R), np.float32) if a is None
                      else np.asarray(a, np.float32))
        c["u"].append(np.zeros((n, self.U), np.float32) if u is None
                      else np.asarray(u, np.float32))
        c["prio"].append(z if prio is None else np.asarray(prio, np.int32))
        c["job"].append(z if job is None else np.asarray(job, np.int32))
        c["cons"].append(np.zeros((n, self.C, 3), np.int32) if cons is None
                         else np.asarray(cons, np.int32))
        c["attr_idx"].append(z if attr_idx is None
                             else np.asarray(attr_idx, np.int32))
        c["attr_val"].append(z if attr_val is None
                             else np.asarray(attr_val, np.int32))

    def cat(self) -> Dict[str, np.ndarray]:
        return {k: np.concatenate(v) for k, v in self.cols.items()}


def _tasks(rng, tr: dict, n: int, C: int, job0: int):
    """``n`` tasks in jobs of heavy-tailed size: (req (n, 3), prio, job,
    cons (n, C, 3), usage fraction) and the next free job id."""
    sizes = np.minimum(1 + rng.pareto(tr["tasks_per_job_pareto"],
                                      n // 2 + 16).astype(np.int64),
                       tr["tasks_per_job_max"])
    while sizes.sum() < n:
        sizes = np.concatenate([sizes, sizes])
    k = int(np.searchsorted(np.cumsum(sizes), n)) + 1
    job = np.repeat(np.arange(job0, job0 + k), sizes[:k])[:n]
    prio = np.asarray(tr["priorities"], np.int32)[
        rng.choice(len(tr["priorities"]), k, p=tr["priority_p"])][job - job0]
    req = np.stack([
        np.clip(rng.lognormal(*tr["req_lognormal"][r], n),
                tr["req_min"][r], tr["req_max"][r]) for r in range(3)], 1)
    cons = np.zeros((n, C, 3), np.int32)
    has = rng.random(n) < tr["constraint_prob"]
    n_c = np.where(has, rng.integers(1, 3, n), 0)
    for c in range(2):
        on = n_c > c
        cons[on, c, 0] = rng.integers(0, tr["attr_keys"], on.sum())
        cons[on, c, 1] = rng.integers(1, 5, on.sum())       # =, !=, <, >
        cons[on, c, 2] = rng.integers(0, 4, on.sum())
    frac = np.clip(rng.beta(*tr["usage_beta"], n), 0.01, 1.0)
    return req.astype(np.float32), prio, job.astype(np.int32), cons, frac, \
        job0 + k


def _usage(rng, req, frac, U: int):
    n = len(frac)
    cpu = req[:, 0] * frac * np.clip(rng.normal(1, .25, n), .05, 2)
    ram = req[:, 1] * frac
    u = np.zeros((n, U), np.float32)
    u[:, 0], u[:, 1], u[:, 2] = cpu, ram, ram * 1.1
    u[:, 3] = ram * 0.15
    u[:, 4] = np.clip(rng.lognormal(-4, 1, n), 0, .5)
    u[:, 5] = req[:, 2] * frac
    u[:, 6] = np.clip(rng.normal(1.5, .4, n), .5, 4)
    u[:, 7] = np.clip(rng.normal(.03, .01, n), .001, .2)
    return u


def make_trace(cell: dict, tr: dict, n_windows: int, seed: int,
               events_per_window: int, real_slots: int
               ) -> Dict[str, np.ndarray]:
    """``n_windows`` packed windows of the cell, every field a (W, E, ...)
    array (``E = cell['max_events_per_window']``; the rows past
    ``events_per_window`` stay PAD for on-device injection, and task slots
    stay below ``real_slots``), plus ``declared``: the number of
    declaration windows."""
    R, U = cell["n_resources"], cell["n_usage_stats"]
    C, E = cell["max_constraints"], cell["max_events_per_window"]
    cap = events_per_window
    M, N0, period = tr["machines"], tr["running_at_start"], tr["usage_period"]
    rng = rng_for(seed, 1)

    # --- declarations: machines, attributes, the running tasks -----------
    base_cap = np.asarray(tr["platforms"], np.float32)[
        rng.integers(0, len(tr["platforms"]), M)]
    base_cap = np.concatenate([base_cap, np.ones((M, 1), np.float32)], 1)
    lo_a, hi_a = tr["attrs_per_machine"]
    n_attr = rng.integers(lo_a, hi_a + 1, M)
    keys = np.argsort(rng.random((M, tr["attr_keys"])), 1)
    am, ak = np.nonzero(np.arange(tr["attr_keys"])[None] < n_attr[:, None])
    attr_m, attr_k = am, keys[am, ak]
    attr_v = rng.integers(tr["attr_values"][0], tr["attr_values"][1] + 1,
                          len(am))
    req0, prio0, job0, cons0, frac0, next_job = _tasks(rng, tr, N0, C, 0)
    n_decl = M + len(attr_m) + N0
    D = -(-n_decl // cap)
    decl_w = np.arange(n_decl) // cap
    rows = _Rows(R, U, C)
    rows.add(decl_w[:M], ADD_NODE, np.arange(M), a=base_cap)
    rows.add(decl_w[M:M + len(attr_m)], ADD_NODE_ATTR, attr_m,
             attr_idx=attr_k, attr_val=attr_v)
    start0 = decl_w[M + len(attr_m):]
    rows.add(start0, ADD_TASK, np.arange(N0), a=req0, prio=prio0, job=job0,
             cons=cons0)

    # lifetimes: a share of long-lived services, the rest batch tasks; the
    # starting population holds them in their stationary proportion
    s_share, s_mean, b_mean = (tr["service_share"], tr["service_mean"],
                               tr["batch_mean"])
    mean_life = s_share * s_mean + (1 - s_share) * b_mean
    p_service0 = s_share * s_mean / mean_life
    life0 = np.where(rng.random(N0) < p_service0, s_mean, b_mean)
    end0 = D + np.maximum(1, np.round(rng.exponential(life0))).astype(np.int64)
    lam = N0 / mean_life

    # --- arrivals, window by window (slots from a free list) ------------
    n_arr = rng.poisson(lam, max(0, n_windows - D))
    A = int(n_arr.sum())
    reqA, prioA, jobA, consA, fracA, _ = _tasks(rng, tr, A, C, next_job)
    lifeA = np.where(rng.random(A) < s_share, s_mean, b_mean)
    durA = np.maximum(1, np.round(rng.exponential(lifeA))).astype(np.int64)
    startA = np.repeat(np.arange(D, n_windows), n_arr)
    endA = startA + durA
    slotA = np.empty(A, np.int32)
    ends_at: Dict[int, List[np.ndarray]] = {}
    order0 = np.argsort(end0, kind="stable")
    e_sorted = end0[order0]
    free: List[int] = list(range(real_slots - 1, N0 - 1, -1))
    cursor0 = 0
    i = 0
    for w in range(D, n_windows):
        # slots whose task ended before this window are free again
        hi0 = int(np.searchsorted(e_sorted, w, side="left"))
        if hi0 > cursor0:
            free.extend(order0[cursor0:hi0][::-1].tolist())
            cursor0 = hi0
        for s in ends_at.pop(w - 1, ()):
            free.extend(s.tolist())
        k = int(n_arr[w - D])
        if k > len(free):
            raise ValueError(f"window {w}: {k} arrivals, {len(free)} free "
                             "task slots")
        got = np.asarray(free[len(free) - k:][::-1], np.int32)
        del free[len(free) - k:]
        slotA[i:i + k] = got
        e = endA[i:i + k]
        for ew in np.unique(e):
            if ew < n_windows:
                ends_at.setdefault(int(ew), []).append(got[e == ew])
        i += k
    rows.add(startA, ADD_TASK, slotA, a=reqA, prio=prioA, job=jobA,
             cons=consA)

    # --- ends, updates, usage samples of every task ----------------------
    slot = np.concatenate([np.arange(N0, dtype=np.int32), slotA])
    start = np.concatenate([start0.astype(np.int64), startA])
    end = np.concatenate([end0, endA])
    req = np.concatenate([req0, reqA])
    prio = np.concatenate([prio0, prioA])
    frac = np.concatenate([frac0, fracA])
    ends = end < n_windows
    evict = rng.random(len(end)) < tr["evict_share"]
    a_end = np.zeros((int(ends.sum()), R), np.float32)
    a_end[:, 0] = np.where(evict[ends], REMOVE_REASON_EVICT, 0.0)
    rows.add(end[ends], REMOVE_TASK, slot[ends], a=a_end)
    first = np.maximum(start + 1, D)
    upd = (rng.random(len(end)) < tr["update_prob"])
    up_w = first + (rng.random(len(end)) * np.maximum(end - first, 1)).astype(
        np.int64)
    upd &= (up_w < end) & (up_w < n_windows)
    up_a = req[upd].copy()
    up_a[:, 0] *= 1.5
    rows.add(up_w[upd], UPDATE_TASK_REQUIRED, slot[upd], a=up_a,
             prio=prio[upd])
    phase = first + rng.integers(0, period, len(end))
    stop = np.minimum(end, n_windows)
    n_use = np.where(phase < stop, (stop - 1 - phase) // period + 1, 0)
    t = np.repeat(np.arange(len(end)), n_use)
    k_in = np.arange(len(t)) - np.repeat(np.cumsum(n_use) - n_use, n_use)
    rows.add(phase[t] + k_in * period, UPDATE_TASK_USED, slot[t],
             u=_usage(rng, req[t], frac[t], U))

    # --- machine churn ---------------------------------------------------
    up_until = np.full(M, -1, np.int64)      # down until (exclusive)
    for w in range(D, n_windows):
        busy = set()
        for _ in range(rng.poisson(tr["machine_removals"])):
            m = int(rng.integers(0, M))
            if up_until[m] >= w or m in busy:
                continue
            back = w + 1 + int(rng.geometric(1.0 / tr["machine_downtime"]))
            up_until[m] = back
            busy.add(m)
            rows.add(w, REMOVE_NODE, [m])
            if back < n_windows:
                rows.add(back, ADD_NODE, [m], a=base_cap[m:m + 1])
        for _ in range(rng.poisson(tr["capacity_updates"])):
            m = int(rng.integers(0, M))
            if up_until[m] >= w or m in busy:
                continue
            busy.add(m)
            a = base_cap[m:m + 1].copy()
            a[0, 0] *= rng.choice([0.5, 1.0, 2.0])
            rows.add(w, UPDATE_NODE_RESOURCES, [m], a=a)

    # --- pack ------------------------------------------------------------
    ev = rows.cat()
    keep = ev["window"] < n_windows
    ev = {k: v[keep] for k, v in ev.items()}
    table = np.zeros(16, np.int64)
    for k, g in _GROUP.items():
        table[k] = g
    grp = table[ev["kind"]]
    order = np.lexsort((np.arange(len(grp)), grp, ev["window"]))
    ev = {k: v[order] for k, v in ev.items()}
    win = ev["window"]
    counts = np.bincount(win, minlength=n_windows)
    if counts.max(initial=0) > cap:
        w = int(counts.argmax())
        raise ValueError(f"window {w} holds {counts[w]} rows > {cap}")
    pos = np.arange(len(win)) - np.repeat(np.cumsum(counts) - counts, counts)
    out = {
        "kind": np.zeros((n_windows, E), np.int8),
        "slot": np.zeros((n_windows, E), np.int32),
        "a": np.zeros((n_windows, E, R), np.float32),
        "u": np.zeros((n_windows, E, U), np.float32),
        "prio": np.zeros((n_windows, E), np.int32),
        "job": np.zeros((n_windows, E), np.int32),
        "constraints": np.zeros((n_windows, E, C, 3), np.int32),
        "attr_idx": np.zeros((n_windows, E), np.int32),
        "attr_val": np.zeros((n_windows, E), np.int32),
        "t_off": np.zeros((n_windows, E), np.int32),
        "n_valid": counts.astype(np.int32),
    }
    for f, src in (("kind", "kind"), ("slot", "slot"), ("a", "a"),
                   ("u", "u"), ("prio", "prio"), ("job", "job"),
                   ("constraints", "cons"), ("attr_idx", "attr_idx"),
                   ("attr_val", "attr_val")):
        out[f][win, pos] = ev[src]
    out["t_off"][win, pos] = (rng_for(seed, 2).random(len(win))
                              * cell["window_us"]).astype(np.int32)
    out["declared"] = np.asarray(D)
    return out


def grid_specs(axes: Dict[str, Sequence]) -> List[dict]:
    """The cartesian what-if grid: one spec dict per lane, named by its
    values, in the order the axes are given."""
    keys = list(axes)
    specs = []
    for combo in itertools.product(*axes.values()):
        spec = dict(zip(keys, combo))
        spec["name"] = "/".join(f"{k}={v}" for k, v in spec.items())
        specs.append(spec)
    return specs


def query_sequence(seed: int, specs: List[dict], n: int) -> List[int]:
    """``n`` grid spec indices to ask in turn, from the seed: cycles that
    hold one spec of each scheduler, in an order drawn from the seed, each
    scheduler's specs taken in a drawn order. Every seed asks the same
    mix of schedulers, which sets a query's cost, in another order."""
    rng = rng_for(seed, 11)
    by = {}
    for i, s in enumerate(specs):
        by.setdefault(s["scheduler"], []).append(i)
    cycles = -(-n // len(by))
    cols = [[own[j] for _ in range(-(-cycles // len(own)))
             for j in rng.permutation(len(own))] for own in by.values()]
    seq = []
    for c in range(cycles):
        seq += [cols[k][c] for k in rng.permutation(len(by))]
    return seq[:n]


def sample_lanes(seed: int, n_lanes: int, k: int) -> List[int]:
    """The lanes the reference follows: ``k`` of ``n_lanes``, from the
    seed, in lane order."""
    return sorted(rng_for(seed, 3).choice(n_lanes, min(k, n_lanes),
                                          replace=False).tolist())
