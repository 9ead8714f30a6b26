"""Plain reference of the what-if fleet: B worlds of one cell advanced
window by window over one shared event stream, in PyTorch tensor ops with
no kernel, no batching across windows and no pipeline.

It follows the AGOCS engine's semantics as the GCD v2 schema and the
what-if knobs define them: per window the shared events are perturbed for
each world (outage, capacity scaling, thinning, surge, usage scaling,
injected SUBMITs), node and task events are applied with per-node
accounting deltas, invalid placements are evicted, an eviction storm and
the injected tasks' expiry run, and the top ``sched_batch`` pending tasks
by priority are committed one after another against the running
reservation tally (best fit re-scored against the tally, first fit,
round robin, or a uniform random preference). Every ``resync_windows``
windows (at batch boundaries) both tallies are summed again from the task
table. Each window ends with a stats row.

The commit scan is sequential over the batch's tasks, as the semantics
are; it runs every lane of a step at once. Everything here is a plain
expression of the float order the simulator defines (resource columns
added from 0 in index order, the node spreads summed in float64), so the
reference and a correct program agree bitwise on decisions and counts.

``float_dtype`` below float32 makes the reference a lower-precision
control: every float the state and the windows store is rounded to that
type after each pass that writes it, the arithmetic staying float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from portbench.reference import prng

# event kinds (the engine's vocabulary) and task states
PAD, ADD_TASK, UPDATE_TASK_REQUIRED, UPDATE_TASK_USED = 0, 1, 2, 3
UPDATE_TASK_CONSTRAINTS, REMOVE_TASK, ADD_NODE = 4, 5, 6
UPDATE_NODE_RESOURCES, ADD_NODE_ATTR = 7, 8
REMOVE_NODE_ATTR, REMOVE_NODE = 9, 10
TASK_KINDS = (ADD_TASK, UPDATE_TASK_REQUIRED, UPDATE_TASK_USED,
              UPDATE_TASK_CONSTRAINTS, REMOVE_TASK)
TASK_EMPTY, TASK_PENDING, TASK_RUNNING = 0, 1, 2
OP_EQ, OP_NE, OP_LT, OP_GT = 1, 2, 3, 4
REMOVE_REASON_EVICT = 2
ACCOUNTED_USAGE_COLS = (0, 1, 5)     # cpu rate, canonical memory, disk space
N_PRIO = 12
INT32_MIN = -2 ** 31
NEG = float("-inf")

SALT_OUTAGE, SALT_THIN, SALT_SURGE = 0x1, 0x2, 0x4
SALT_STORM, SALT_INJECT, SALT_LIFETIME = 0x5, 0x6, 0x7
M32 = 0xFFFFFFFF

FIELDS = ("kind", "slot", "a", "u", "prio", "job", "constraints",
          "attr_idx", "attr_val", "t_off", "n_valid")


@dataclasses.dataclass(frozen=True)
class Cell:
    """The sizes the reference needs (a cell's configuration file)."""
    max_nodes: int
    max_tasks: int
    max_events_per_window: int
    n_resources: int
    n_usage_stats: int
    n_attr_slots: int
    max_constraints: int
    sched_batch: int
    resync_windows: int
    inject_slots: int = 0
    inject_task_slots: int = 0
    storm_max_victims: int = 0
    scenario_salt: int = 0x5DEECE66

    @property
    def pool(self) -> int:
        if not self.inject_slots:
            return 0
        return self.inject_task_slots or min(self.max_tasks // 4,
                                             self.inject_slots * 64)

    @property
    def real_task_slots(self) -> int:
        return self.max_tasks - self.pool

    @property
    def storm_cap(self) -> int:
        if self.storm_max_victims:
            return min(self.storm_max_victims, self.max_tasks)
        return min(max(self.max_tasks // 8, 64), self.max_tasks)


# the what-if knobs of one lane; ``family`` is how its scheduler ranks nodes
SCHEDULERS = {            # name: (family, rotation, dynamic best fit)
    "greedy": ("scores", 0, True),
    "first_fit": ("order", 0, False),
    "round_robin": ("order", 131, False),
    "random": ("random", 0, False),
}


class Knobs(NamedTuple):
    outage: torch.Tensor
    capacity: torch.Tensor
    arrival: torch.Tensor
    surge: torch.Tensor
    surge_prio: torch.Tensor
    usage: torch.Tensor
    storm: torch.Tensor


def knobs_of(specs: Sequence[dict], device) -> Knobs:
    def col(key, default, dtype):
        return torch.tensor([s.get(key, default) for s in specs], dtype=dtype,
                            device=device)
    f32 = torch.float32
    return Knobs(col("node_outage_frac", 0.0, f32),
                 col("capacity_scale", 1.0, f32),
                 col("arrival_rate", 1.0, f32),
                 col("priority_surge_frac", 0.0, f32),
                 col("surge_priority", 11, torch.int32),
                 col("usage_scale", 1.0, f32),
                 col("evict_storm_frac", 0.0, f32))


class State(NamedTuple):
    node_active: torch.Tensor      # (B, N) bool
    node_total: torch.Tensor       # (B, N, R) f32
    node_attrs: torch.Tensor       # (B, N, K) i32
    node_reserved: torch.Tensor    # (B, N, R) f32
    node_used: torch.Tensor        # (B, N, R) f32
    task_state: torch.Tensor       # (B, T) i8
    task_req: torch.Tensor         # (B, T, R) f32
    task_usage: torch.Tensor       # (B, T, U) f32
    task_node: torch.Tensor        # (B, T) i32
    task_prio: torch.Tensor        # (B, T) i32
    task_job: torch.Tensor         # (B, T) i32
    task_constraints: torch.Tensor  # (B, T, C, 3) i32
    window: torch.Tensor           # (B,) i32
    evictions: torch.Tensor
    completions: torch.Tensor
    placements: torch.Tensor
    overflow_drops: torch.Tensor


def empty_state(cell: Cell, B: int, device) -> State:
    N, T, R = cell.max_nodes, cell.max_tasks, cell.n_resources
    U, K, C = cell.n_usage_stats, cell.n_attr_slots, cell.max_constraints
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype):
        return torch.zeros((B,) + shape, dtype=dtype, device=device)

    return State(z((N,), torch.bool), z((N, R), f32), z((N, K), i32),
                 z((N, R), f32), z((N, R), f32), z((T,), torch.int8),
                 z((T, R), f32), z((T, U), f32),
                 torch.full((B, T), -1, dtype=i32, device=device),
                 z((T,), i32), z((T,), i32), z((T, C, 3), i32),
                 z((), i32), z((), i32), z((), i32), z((), i32), z((), i32))


# --- row scatters: last unmasked row wins; masked rows are dropped --------

def _lane_flat(rows, n):
    rows = rows.long()
    off = torch.arange(rows.shape[0], device=rows.device)[:, None] * n
    return torch.where((rows >= 0) & (rows < n), rows + off, -1).reshape(-1)


def set_rows_(dst, rows, mask, vals):
    """dst (B, n, ...)[rows[b, e]] = vals[b, e] where mask, per lane."""
    B, n = dst.shape[0], dst.shape[1]
    flat = dst.view((B * n,) + tuple(dst.shape[2:]))
    r = _lane_flat(rows, n)
    m = mask.reshape(-1)
    if isinstance(vals, torch.Tensor):
        vals = vals.reshape((-1,) + tuple(vals.shape[2:]))
    nn, E = flat.shape[0], r.shape[0]
    ok = m & (r >= 0) & (r < nn)
    order = torch.arange(E, device=dst.device)
    last = torch.full((nn + E,), -1, dtype=torch.long, device=dst.device)
    last.scatter_reduce_(0, torch.where(ok, r, nn + order), order, "amax")
    rc = r.clamp(0, nn - 1)
    win = last[rc]
    old = flat[rc]
    have = (win >= 0).view((E,) + (1,) * (old.dim() - 1))
    if isinstance(vals, torch.Tensor):
        vals = vals[win.clamp_min(0)].to(flat.dtype)
    flat[rc] = torch.where(have, vals, old)


def add_rows(acc, rows, mask, vals):
    """acc (B, N, R) plus vals (B, E, R) at rows where mask; a new tensor."""
    B, n = acc.shape[0], acc.shape[1]
    flat = acc.reshape((B * n,) + tuple(acc.shape[2:]))
    r = _lane_flat(rows, n)
    m = mask.reshape(-1)
    v = vals.reshape((-1,) + tuple(vals.shape[2:]))
    nn, E = flat.shape[0], r.shape[0]
    ok = m & (r >= 0) & (r < nn)
    buf = torch.cat([flat, flat.new_zeros((E,) + tuple(flat.shape[1:]))])
    spill = nn + torch.arange(E, device=acc.device)
    buf.index_put_((torch.where(ok, r, spill),),
                   torch.where(m[:, None], v, 0.0), accumulate=True)
    return buf[:nn].view(acc.shape)


def take(x, idx):
    lanes = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lanes, idx.long()]


def accounted(usage):
    return usage[..., list(ACCOUNTED_USAGE_COLS)]


def sum_last(x):
    s = torch.zeros_like(x[..., 0])
    for r in range(x.shape[-1]):
        s = s + x[..., r]
    return s


# --- perturbation of the shared window ------------------------------------

def _mul32(a, c):
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash01(x, salt, cell: Cell):
    h = (x.long() & M32) ^ ((cell.scenario_salt + salt) & M32)
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (2.0 ** -32)


def perturb(w: Dict[str, torch.Tensor], k: Knobs, cell: Cell, window):
    """One shared window (E, ...) -> each lane's window (B, E, ...)."""
    B = k.outage.shape[0]
    kind = w["kind"]
    node_cap = (kind == ADD_NODE) | (kind == UPDATE_NODE_RESOURCES)
    is_add = kind == ADD_TASK
    is_task = torch.zeros_like(is_add)
    for tk in TASK_KINDS:
        is_task = is_task | (kind == tk)
    drop = node_cap & (hash01(w["slot"], SALT_OUTAGE, cell)
                       < k.outage[:, None])
    a = torch.where(node_cap[:, None], w["a"] * k.capacity[:, None, None],
                    w["a"])
    thin = 1.0 - torch.clamp_max(k.arrival, 1.0)
    drop = drop | (is_task & (hash01(w["slot"], SALT_THIN, cell)
                              < thin[:, None]))
    new_kind = kind.expand(drop.shape).masked_fill(drop, PAD)
    is_prio = is_add | (kind == UPDATE_TASK_REQUIRED)
    surged = is_prio & ~drop & (hash01(w["slot"], SALT_SURGE, cell)
                                < k.surge[:, None])
    prio = torch.where(surged, k.surge_prio[:, None], w["prio"])
    is_use = kind == UPDATE_TASK_USED
    u = torch.where(is_use[:, None], w["u"] * k.usage[:, None, None], w["u"])
    out = {f: w[f].expand((B,) + tuple(w[f].shape)) for f in FIELDS
           if f != "n_valid"}
    out.update(kind=new_kind, a=a, prio=prio, u=u)
    if cell.inject_slots:
        out = inject(out, k, cell, window)
    return out


def inject(w, k: Knobs, cell: Cell, window):
    S = cell.inject_slots
    B, E = w["kind"].shape
    dev = w["kind"].device
    j = torch.arange(S, device=dev)
    arrive = w["kind"] == ADD_TASK
    n_arr = arrive.sum(-1, dtype=torch.int32)
    n_inj = torch.clamp(
        torch.round((k.arrival - 1.0) * n_arr.to(torch.float32))
        .to(torch.int32), 0, S)
    active = (j[None, :] < n_inj[:, None]) & (n_arr > 0)[:, None]
    mix = (_mul32(window.long() & M32, 0x9E3779B1)[:, None]
           + _mul32(j, 0x85EBCA77)[None, :]) & M32
    pick = torch.floor(hash01(mix, SALT_INJECT, cell)
                       * n_arr.to(torch.float32)[:, None]).to(torch.int32)
    pick = torch.minimum(pick.clamp_min(0), (n_arr - 1).clamp_min(0)[:, None])
    cum = torch.cumsum(arrive.to(torch.int32), -1, dtype=torch.int32)
    src = torch.searchsorted(cum, (pick + 1).contiguous()).clamp(0, E - 1)
    islot = cell.real_task_slots + torch.remainder(
        window[:, None] * S + j[None, :].to(torch.int32), cell.pool)

    def put(col, new):
        cur = col[:, E - S:]
        mask = active.view((B, S) + (1,) * (cur.dim() - 2))
        return torch.cat([col[:, :E - S], torch.where(mask, new, cur)], dim=1)

    out = dict(w)
    out["kind"] = put(w["kind"],
                      torch.full_like(w["kind"][:, E - S:], ADD_TASK))
    out["slot"] = put(w["slot"], islot.to(w["slot"].dtype))
    for f in ("a", "u", "prio", "job", "constraints", "attr_idx", "attr_val",
              "t_off"):
        out[f] = put(w[f], take(w[f], src))
    return out


# --- event application -----------------------------------------------------

def apply_node_events(s: State, w, cell: Cell) -> State:
    N, K = cell.max_nodes, cell.n_attr_slots
    kind, slot = w["kind"], w["slot"]
    add, upd, rem = (kind == ADD_NODE, kind == UPDATE_NODE_RESOURCES,
                     kind == REMOVE_NODE)
    set_rows_(s.node_active, slot, add, True)
    set_rows_(s.node_total, slot, add | upd, w["a"])
    aat, rat = kind == ADD_NODE_ATTR, kind == REMOVE_NODE_ATTR
    in_range = ((slot >= 0) & (slot < N) & (w["attr_idx"] >= 0)
                & (w["attr_idx"] < K))
    flat = slot.long() * K + w["attr_idx"].long()
    set_rows_(s.node_attrs.view(s.node_attrs.shape[0], -1), flat,
              (aat | rat) & in_range, torch.where(aat, w["attr_val"], 0))
    set_rows_(s.node_active, slot, rem, False)
    return s


def apply_task_events(s: State, w, cell: Cell) -> State:
    T = cell.max_tasks
    kind, slot = w["kind"], w["slot"]
    rem, add = kind == REMOVE_TASK, kind == ADD_TASK
    upd, ucon = kind == UPDATE_TASK_REQUIRED, kind == UPDATE_TASK_CONSTRAINTS
    use = kind == UPDATE_TASK_USED
    at = slot.long().clamp(0, T - 1)
    old_state = take(s.task_state, at)
    live = old_state != TASK_EMPTY
    was_running = old_state == TASK_RUNNING
    ev_node = take(s.task_node, at)
    old_req = take(s.task_req, at)
    old_used = accounted(take(s.task_usage, at))
    gone = (rem | add) & was_running
    reserved = add_rows(s.node_reserved, ev_node, gone, -old_req)
    used = add_rows(s.node_used, ev_node, gone, -old_used)
    reserved = add_rows(reserved, ev_node, upd & was_running, w["a"] - old_req)

    evicted = rem & live & (w["a"][..., 0] == float(REMOVE_REASON_EVICT))
    n_evict = evicted.sum(-1, dtype=torch.int32)
    n_rem = (rem & live).sum(-1, dtype=torch.int32) - n_evict
    set_rows_(s.task_state, slot, rem, TASK_EMPTY)
    set_rows_(s.task_node, slot, rem, -1)
    set_rows_(s.task_state, slot, add, TASK_PENDING)
    set_rows_(s.task_node, slot, add, -1)
    set_rows_(s.task_req, slot, add | upd, w["a"])
    set_rows_(s.task_prio, slot, add | upd, w["prio"])
    set_rows_(s.task_job, slot, add, w["job"])
    set_rows_(s.task_constraints, slot, add | ucon, w["constraints"])
    samp = use & (take(s.task_state, at) == TASK_RUNNING)
    used = add_rows(used, ev_node, samp, accounted(w["u"]) - old_used)
    set_rows_(s.task_usage, slot, use, w["u"])
    return s._replace(node_reserved=reserved, node_used=used,
                      completions=s.completions + n_rem,
                      evictions=s.evictions + n_evict)


def evict_invalid(s: State) -> State:
    node_idx = s.task_node.clamp_min(0)
    dead = ~take(s.node_active, node_idx)
    over = (s.node_reserved > s.node_total + 1e-6).any(dim=-1)
    bad = (s.task_state == TASK_RUNNING) & (dead | take(over, node_idx))
    s.task_state.masked_fill_(bad, TASK_PENDING)
    s.task_node.masked_fill_(bad, -1)
    bad_node = (~s.node_active | over)[..., None]
    return s._replace(evictions=s.evictions + bad.sum(-1, dtype=torch.int32),
                      node_reserved=torch.where(bad_node, 0.0,
                                                s.node_reserved),
                      node_used=torch.where(bad_node, 0.0, s.node_used))


def segment_sum(task_node, values, mask, n_nodes):
    B, T, V = values.shape
    idx = torch.where(mask & (task_node >= 0), task_node.long(), n_nodes)
    idx = idx + torch.arange(B, device=idx.device)[:, None] * (n_nodes + 1)
    out = torch.zeros((B * (n_nodes + 1), V), dtype=torch.float32,
                      device=values.device)
    out.index_put_((idx.reshape(-1),), values.reshape(B * T, V),
                   accumulate=True)
    return out.view(B, n_nodes + 1, V)[:, :n_nodes]


def resync(s: State, cell: Cell) -> State:
    running = s.task_state == TASK_RUNNING
    return s._replace(
        node_reserved=segment_sum(s.task_node, s.task_req, running,
                                  cell.max_nodes),
        node_used=segment_sum(s.task_node, accounted(s.task_usage), running,
                              cell.max_nodes))


def storm(s: State, k: Knobs, cell: Cell) -> State:
    T, V = cell.max_tasks, cell.storm_cap
    slots = torch.arange(T, device=s.window.device)
    mix = (_mul32(slots, 0x9E3779B1)[None, :]
           + _mul32(s.window.long() & M32, 0x85EBCA77)[:, None]) & M32
    hit = hash01(mix, SALT_STORM, cell) < k.storm[:, None]
    victim = (s.task_state == TASK_RUNNING) & hit
    if V >= T:
        vals = torch.cat([s.task_req, accounted(s.task_usage)], dim=-1)
        sub = segment_sum(s.task_node, vals, victim, cell.max_nodes)
        R = s.task_req.shape[-1]
        s = s._replace(node_reserved=s.node_reserved - sub[..., :R],
                       node_used=s.node_used - sub[..., R:])
    else:
        cum = torch.cumsum(victim.to(torch.int32), -1, dtype=torch.int32)
        victim = victim & (cum <= V)
        B = cum.shape[0]
        ranks = torch.arange(1, V + 1, dtype=cum.dtype, device=cum.device)
        vrows = torch.searchsorted(cum, ranks.expand(B, V).contiguous())
        valid = (torch.arange(V, device=cum.device)[None, :]
                 < torch.clamp_max(cum[:, -1], V)[:, None])
        rows = vrows.clamp_max(T - 1)
        vnode = take(s.task_node, rows)
        s = s._replace(
            node_reserved=add_rows(s.node_reserved, vnode, valid,
                                   -take(s.task_req, rows)),
            node_used=add_rows(s.node_used, vnode, valid,
                               -accounted(take(s.task_usage, rows))))
    n = victim.sum(-1, dtype=torch.int32)
    s.task_state.masked_fill_(victim, TASK_PENDING)
    s.task_node.masked_fill_(victim, -1)
    return s._replace(evictions=s.evictions + n)


def expire_injected(s: State, k: Knobs, cell: Cell) -> State:
    S, pool = cell.inject_slots, cell.pool
    L = pool // S if S else 0
    if L <= 1:
        return s
    dev = s.window.device
    q = torch.arange(pool, dtype=torch.int32, device=dev)
    dur = (1 + torch.floor(hash01(q, SALT_LIFETIME, cell) * (L - 1))
           .to(torch.int32)).clamp(1, L - 1)
    w0 = s.window[:, None] - dur[None, :]
    injected_then = torch.remainder(q[None, :] - w0 * S, pool) < S
    lo = cell.real_task_slots
    ts, tn = s.task_state[:, lo:lo + pool], s.task_node[:, lo:lo + pool]
    victim = (injected_then & (w0 >= 0) & (ts != TASK_EMPTY)
              & (k.arrival > 1.0)[:, None])
    n = victim.sum(-1, dtype=torch.int32)
    was_running = victim & (ts == TASK_RUNNING)
    rows = tn.clone()
    s = s._replace(
        node_reserved=add_rows(s.node_reserved, rows, was_running,
                               -s.task_req[:, lo:lo + pool]),
        node_used=add_rows(s.node_used, rows, was_running,
                           -accounted(s.task_usage[:, lo:lo + pool])))
    ts.masked_fill_(victim, TASK_EMPTY)
    tn.masked_fill_(victim, -1)
    return s._replace(completions=s.completions + n)


# --- scheduling ------------------------------------------------------------

def pending_batch(s: State, cell: Cell):
    pend = s.task_state == TASK_PENDING
    keyv = torch.where(pend, s.task_prio, INT32_MIN)
    _, order = torch.sort(keyv, dim=-1, descending=True, stable=True)
    idx = order[..., :cell.sched_batch]
    return idx, pend.gather(-1, idx)


def placement_scores(req, cons, total, reserved, attrs, active):
    """One lane: (P, N) best-fit scores, -inf where a constraint or the
    free capacity rules the node out."""
    K = attrs.shape[1]
    ai = cons[:, :, 0].long()
    ai = torch.where(ai < 0, ai + K, ai).clamp(0, K - 1)
    op, val = cons[:, :, 1][None], cons[:, :, 2][None]
    got = attrs[:, ai]
    ok = torch.where(op == OP_EQ, got == val,
         torch.where(op == OP_NE, got != val,
         torch.where(op == OP_LT, got < val,
         torch.where(op == OP_GT, got > val, True)))).all(dim=-1).T
    free = total - reserved
    ok = ok & (req[:, None, :] <= free[None, :, :] + 1e-9).all(dim=-1)
    ok = ok & active[None, :]
    denom = torch.clamp_min(total, 1e-6)
    score = -sum_last((free[None] - req[:, None]) / denom[None])
    return torch.where(ok, score, NEG)


def commit(pref_static, dyn, is_random, rand, req, ok, valid, total, denom,
           reserved0):
    """The capacity-checked assignment of every lane, task by task in
    priority order. pref_static (B, N) (node order) or None, dyn (B,) bool,
    is_random (B,) bool, rand (P, N) shared draws or None, req (B, P, R),
    ok (B, P, N), valid (B, P), total/denom/reserved0 (B, N, R)."""
    B, P = valid.shape
    reserved = reserved0.clone()
    node_of = torch.full((B, P), -1, dtype=torch.int32, device=req.device)
    lanes = torch.arange(B, device=req.device)
    for i in range(P):
        r = req[:, i][:, None, :]
        free = total - reserved
        fit = (r <= free + 1e-9).all(dim=-1) & ok[:, i]
        sc = -sum_last((free - r) / denom)
        if pref_static is not None:
            st = pref_static
            if rand is not None:
                st = torch.where(is_random[:, None], rand[i][None], st)
            sc = torch.where(dyn[:, None], sc, st)
        sc = torch.where(fit, sc, NEG)
        n = torch.argmax(sc, dim=-1)
        can = fit[lanes, n] & valid[:, i]
        add = torch.where(can[:, None], req[:, i], 0.0)
        reserved[lanes, n] = reserved[lanes, n] + add
        node_of[:, i] = torch.where(can, n.to(torch.int32), -1)
    return node_of, reserved


class CapturedCommit:
    """:func:`commit` recorded once as a CUDA graph and replayed for each
    window: the scan's thousands of small launches a window then cost the
    device's time and not the host's. Same operations, same order."""

    def __init__(self, args):
        self.inputs = [None if a is None else a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            commit(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = commit(*self.inputs)

    def __call__(self, args):
        for dst, src in zip(self.inputs, args):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


class Fleet:
    """B lanes of one cell: ``step`` advances one window and returns its
    stats rows."""

    def __init__(self, cell: Cell, specs: Sequence[dict], device,
                 has_storm: Optional[bool] = None,
                 float_dtype: torch.dtype = torch.float32):
        self.cell = cell
        self.device = device
        self.specs = list(specs)
        self.knobs = knobs_of(self.specs, device)
        self.state = empty_state(cell, len(self.specs), device)
        self.has_storm = (any(s.get("evict_storm_frac", 0.0) > 0
                              for s in self.specs)
                          if has_storm is None else has_storm)
        fams = [SCHEDULERS[s.get("scheduler", "greedy")] for s in self.specs]
        self.dyn = torch.tensor([f[2] for f in fams], device=device)
        self.is_random = torch.tensor([f[0] == "random" for f in fams],
                                      device=device)
        self.rot = torch.tensor([f[1] for f in fams], dtype=torch.int32,
                                device=device)
        self.any_static = any(not f[2] for f in fams)
        self.any_random = any(f[0] == "random" for f in fams)
        self.float_dtype = float_dtype
        self._commit = None

    def _round(self, s: State) -> State:
        if self.float_dtype == torch.float32:
            return s
        rnd = {f: getattr(s, f).to(self.float_dtype).to(torch.float32)
               for f in ("node_total", "node_reserved", "node_used",
                         "task_req", "task_usage")}
        return s._replace(**rnd)

    def _window(self, w):
        if self.float_dtype == torch.float32:
            return w
        w = dict(w)
        for f in ("a", "u"):
            w[f] = w[f].to(self.float_dtype).to(torch.float32)
        return w

    def step(self, w: Dict[str, torch.Tensor], rng) -> Dict[str, torch.Tensor]:
        cell, k = self.cell, self.knobs
        s = self.state
        w = self._window(perturb(w, k, cell, s.window))
        if cell.inject_slots:
            injected = (w["kind"][:, -cell.inject_slots:] == ADD_TASK).sum(
                -1, dtype=torch.int32)
        else:
            injected = torch.zeros_like(s.window)
        s = apply_node_events(s, w, cell)
        s = self._round(apply_task_events(s, w, cell))
        s = evict_invalid(s)
        if self.has_storm:
            s = self._round(storm(s, k, cell))
        if cell.inject_slots:
            s = self._round(expire_injected(s, k, cell))
        s = self._round(self._dispatch(s, rng))
        self.state = s._replace(window=s.window + 1)
        row = window_stats(self.state)
        row["injected_arrivals"] = injected
        return row

    def _dispatch(self, s: State, rng) -> State:
        cell = self.cell
        N = cell.max_nodes
        idx, valid = pending_batch(s, cell)
        req = take(s.task_req, idx)
        scores = torch.stack([
            placement_scores(req[b], take(s.task_constraints, idx)[b],
                             s.node_total[b], s.node_reserved[b],
                             s.node_attrs[b], s.node_active[b])
            for b in range(idx.shape[0])])
        ok = torch.isfinite(scores)
        del scores
        total = torch.where(s.node_active[..., None], s.node_total, -1.0)
        denom = torch.clamp_min(s.node_total, 1e-6)
        pref = rand = None
        if self.any_static:
            start = torch.remainder(s.window * self.rot, N)
            order = torch.remainder(
                torch.arange(N, dtype=torch.int32,
                             device=s.window.device)[None]
                - start[:, None], N)
            pref = -order.to(torch.float32)
        if self.any_random:
            rand = prng.uniform(rng, (cell.sched_batch, N))
        args = (pref, self.dyn, self.is_random, rand, req, ok, valid, total,
                denom, s.node_reserved)
        if s.window.device.type == "cuda":
            if self._commit is None:
                self._commit = CapturedCommit(args)
            node_of, tally = self._commit(args)
        else:
            node_of, tally = commit(*args)
        placed = node_of >= 0
        lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
        s.task_state[lanes, idx] = torch.where(
            placed, TASK_RUNNING, s.task_state[lanes, idx]).to(torch.int8)
        s.task_node[lanes, idx] = torch.where(placed, node_of,
                                              s.task_node[lanes, idx])
        used = add_rows(s.node_used, node_of, placed,
                        accounted(take(s.task_usage, idx)))
        return s._replace(placements=s.placements
                          + placed.sum(-1, dtype=torch.int32),
                          node_reserved=tally, node_used=used)

    def resync(self):
        self.state = self._round(resync(self.state, self.cell))


# --- stats rows ------------------------------------------------------------

def _spread(values, active, n_div):
    mean = values.double().sum(-1).float() / n_div
    sq = torch.where(active, (values - mean[:, None]) ** 2, 0.0)
    return sq.double().sum(-1).float() / n_div


def window_stats(s: State) -> Dict[str, torch.Tensor]:
    running = s.task_state == TASK_RUNNING
    pending = s.task_state == TASK_PENDING
    prio = s.task_prio.clamp(0, N_PRIO - 1)
    by_prio = torch.stack([
        torch.stack([((prio == p) & running).sum(-1, dtype=torch.int32),
                     ((prio == p) & pending).sum(-1, dtype=torch.int32)], -1)
        for p in range(N_PRIO)], dim=1)
    n_running = by_prio[..., 0].sum(-1, dtype=torch.int32)
    n_pending = by_prio[..., 1].sum(-1, dtype=torch.int32)
    usage_sum = torch.bmm(running.to(torch.float32)[:, None],
                          s.task_usage)[:, 0]
    active = s.node_active
    cap = torch.where(active[..., None], s.node_total, 0.0).sum(1)
    reserved = s.node_reserved.sum(1)
    used = s.node_used.sum(1)
    n_nodes = active.sum(-1, dtype=torch.int32)
    n_div = torch.clamp_min(n_nodes, 1)
    util = torch.where(active[..., None],
                       s.node_used / torch.clamp_min(s.node_total, 1e-9),
                       0.0)[..., 0]
    res_frac = sum_last(torch.where(
        active[..., None],
        s.node_reserved / torch.clamp_min(s.node_total, 1e-9),
        0.0)) * (1.0 / s.node_total.shape[-1])
    denom = torch.clamp_min(cap, 1e-9)
    nr = n_running[:, None]
    return {
        "n_nodes": n_nodes, "n_running": n_running, "n_pending": n_pending,
        "running_by_priority": by_prio[..., 0],
        "pending_by_priority": by_prio[..., 1],
        "capacity": cap, "reserved": reserved, "used": used,
        "reserved_frac": reserved / denom, "used_frac": used / denom,
        "overestimate_frac": 1.0 - used / torch.clamp_min(reserved, 1e-9),
        "usage_mean": torch.where(nr > 0, usage_sum / torch.clamp_min(nr, 1),
                                  0.0),
        "util_balance_var": _spread(util, active, n_div),
        "reserved_balance_var": _spread(res_frac, active, n_div),
        "evictions": s.evictions, "completions": s.completions,
        "placements": s.placements, "overflow_drops": s.overflow_drops,
    }


def replay(fleet: Fleet, windows: Dict[str, np.ndarray], lo: int, hi: int,
           seed: int, batch_windows: int, since_resync: int = 0,
           on_window=None) -> int:
    """Advance ``fleet`` over windows [lo, hi) of a packed stack in batches
    of ``batch_windows``: batch j's keys are the split of ``seed`` plus the
    windows already done, and the tallies are summed again once the
    windows since the last resync reach ``resync_windows`` at a batch's
    end. ``on_window(w, row)`` gets each window's stats row. Returns the
    windows since the last resync."""
    dev = fleet.device
    every = fleet.cell.resync_windows
    w = lo
    while w < hi:
        n = min(batch_windows, hi - w)
        keys = prng.split(prng.key(seed + w, dev), n)
        for j in range(n):
            win = {f: torch.as_tensor(windows[f][w + j]).to(dev)
                   for f in FIELDS}
            row = fleet.step(win, keys[j])
            if on_window is not None:
                on_window(w + j, row)
        w += n
        if every:
            since_resync += n
            if since_resync >= every:
                fleet.resync()
                since_resync = 0
    return since_resync


def report_row(frame: Dict[str, np.ndarray]) -> Dict[str, float]:
    """A what-if answer's comparative row from one lane's (W, ...) stats."""
    return {
        "placements": int(frame["placements"][-1]),
        "completions": int(frame["completions"][-1]),
        "evictions": int(frame["evictions"][-1]),
        "injected": int(frame["injected_arrivals"].sum()),
        "pending_final": int(frame["n_pending"][-1]),
        "pending_mean": float(frame["n_pending"].mean()),
        "running_final": int(frame["n_running"][-1]),
        "nodes_final": int(frame["n_nodes"][-1]),
        "cpu_reserved_frac_mean": float(frame["reserved_frac"][:, 0].mean()),
        "cpu_used_frac_mean": float(frame["used_frac"][:, 0].mean()),
        "util_balance_var_final": float(frame["util_balance_var"][-1]),
    }


__all__ = ["Cell", "Fleet", "State", "FIELDS", "SCHEDULERS", "replay",
           "report_row", "window_stats"]
