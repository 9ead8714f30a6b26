"""Per-scenario perturbations of the shared event stream, for every lane of
the fleet at once.

All scenarios in a fleet consume the SAME parsed ``EventWindow`` (the trace
is parsed once, on the host); divergence is injected on the device by these
transforms, which take the (B,) knobs and return one perturbed window per
lane, (B, E, ...). Every transform is:

* **deterministic** — membership decisions hash the event's slot (and, for
  per-window effects, the window counter) through a splitmix32-style mixer;
* **an exact identity at the default knob values** — lane 0 of a batched
  run with identity knobs equals the single-trajectory engine bit for bit;
* **shape-preserving** — events are masked to ``PAD`` rather than removed.

The knobs' semantics are the reference's (``src/repro/scenarios/
perturb.py``): node outage, capacity scaling, arrival thinning (rate < 1)
and amplification (rate > 1, SUBMIT clones injected into the window's
reserved tail rows and the reserved task-slot pool), priority surge, usage
inflation, eviction storms (capped and compacted by default) and the
lifetimes of injected tasks.

The reference's uint32 arithmetic (the hash, the storm and injection
mixes) is done here in int64 masked to 32 bits; a product with a 32-bit
constant is taken in two 16-bit halves (:func:`_mul32`), so no int64
product overflows.
"""
from __future__ import annotations

import torch

from repro_torch.config import SimConfig
from repro_torch.core.engine import accounted_usage
from repro_torch.core.events import EventKind, EventWindow
from repro_torch.core.scatter import add_rows, take
from repro_torch.core.state import (SimState, TASK_EMPTY, TASK_PENDING,
                                    TASK_RUNNING)
from repro_torch.kernels.segment_usage.ops import segment_usage_lanes
from repro_torch.scenarios.spec import ScenarioKnobs

# distinct per-knob salt offsets so one slot's fates are independent draws
_SALT_OUTAGE = 0x1
_SALT_THIN = 0x2
_SALT_SURGE = 0x4
_SALT_STORM = 0x5
_SALT_INJECT = 0x6
_SALT_LIFETIME = 0x7

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32): every partial
    product stays below 2**48."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash01(x: torch.Tensor, salt: int, cfg: SimConfig) -> torch.Tensor:
    """Deterministic int -> [0, 1) float32 (splitmix32-style finalizer),
    bit for bit the reference's uint32 version."""
    h = (x.long() & _M32) ^ ((cfg.scenario_salt + salt) & _M32)
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (2.0 ** -32)


_TASK_KINDS = (EventKind.ADD_TASK, EventKind.UPDATE_TASK_REQUIRED,
               EventKind.UPDATE_TASK_USED, EventKind.UPDATE_TASK_CONSTRAINTS,
               EventKind.REMOVE_TASK)


def perturb_window(w: EventWindow, k: ScenarioKnobs, cfg: SimConfig,
                   window: torch.Tensor = None) -> EventWindow:
    """Apply every lane's event-stream transforms to one shared window.

    ``w`` is one packed window (E, ...); ``k`` holds (B,) knobs; ``window``
    is the (B,) window counter (state.window), which seeds the per-window
    injection draws (zeros when omitted). Returns the lanes' windows, every
    field (B, E, ...); fields no knob touches are broadcast views.
    """
    B = k.outage_frac.shape[0]
    kind = w.kind
    is_add_node = kind == EventKind.ADD_NODE
    is_upd_node = kind == EventKind.UPDATE_NODE_RESOURCES
    node_cap_ev = is_add_node | is_upd_node
    is_add_task = kind == EventKind.ADD_TASK
    is_task_ev = torch.zeros_like(is_add_task)
    for tk in _TASK_KINDS:
        is_task_ev = is_task_ev | (kind == tk)

    # --- node outage: hashed node slots never come up ---
    outage_hit = hash01(w.slot, _SALT_OUTAGE, cfg) < k.outage_frac[:, None]
    drop = node_cap_ev & outage_hit                             # (B, E)

    # --- capacity scaling on node capacity payloads ---
    a = torch.where(node_cap_ev[:, None],
                    w.a * k.capacity_scale[:, None, None], w.a)

    # --- arrival thinning: the whole task (and its follow-up events) goes ---
    thin_p = 1.0 - torch.clamp_max(k.arrival_rate, 1.0)
    thinned_slot = hash01(w.slot, _SALT_THIN, cfg) < thin_p[:, None]
    drop = drop | (is_task_ev & thinned_slot)

    new_kind = kind.expand(drop.shape).masked_fill(drop, int(EventKind.PAD))

    # --- priority surge on surviving arrivals AND requirement updates (an
    # UPDATE_TASK_REQUIRED rewrites task_prio, so it must stay surged too)
    is_prio_ev = is_add_task | (kind == EventKind.UPDATE_TASK_REQUIRED)
    surged = (is_prio_ev & ~drop &
              (hash01(w.slot, _SALT_SURGE, cfg) < k.surge_frac[:, None]))
    prio = torch.where(surged, k.surge_prio[:, None], w.prio)

    # --- usage inflation ---
    is_use = kind == EventKind.UPDATE_TASK_USED
    u = torch.where(is_use[:, None], w.u * k.usage_scale[:, None, None], w.u)

    lanes = EventWindow(*[f.expand((B,) + tuple(f.shape)) for f in w])
    w = lanes._replace(kind=new_kind, a=a, prio=prio, u=u)

    # --- arrival amplification (rate > 1): synthesise SUBMITs into the
    # reserved slot pool, cloned from the post-perturbation stream
    if cfg.inject_slots:
        if window is None:
            window = torch.zeros(B, dtype=torch.int32, device=kind.device)
        w = inject_arrivals(w, k, cfg, window)
    return w


def inject_arrivals(w: EventWindow, k: ScenarioKnobs, cfg: SimConfig,
                    window: torch.Tensor) -> EventWindow:
    """Fill every lane's reserved tail rows with synthesised SUBMIT events.

    round((rate - 1) * n_arrivals) clones (capped at ``cfg.inject_slots``)
    of deterministically sampled surviving real arrivals are written into
    rows [E - inject_slots, E), with fresh task ids drawn round-robin from
    the reserved pool [cfg.real_task_slots, max_tasks). At rate <= 1 (or
    with no surviving arrivals) every reserved row keeps its original bits.
    """
    S = cfg.inject_slots
    B, E = w.kind.shape
    dev = w.kind.device
    j = torch.arange(S, device=dev)

    # surviving real arrivals are the cloning sources (reserved rows are
    # still PAD at this point, so they can't self-select)
    arrive = w.kind == EventKind.ADD_TASK
    n_arr = arrive.sum(-1, dtype=torch.int32)                   # (B,)
    n_inj = torch.clamp(
        torch.round((k.arrival_rate - 1.0) * n_arr.to(torch.float32))
        .to(torch.int32), 0, S)
    active = (j[None, :] < n_inj[:, None]) & (n_arr > 0)[:, None]   # (B, S)

    # pick the u*n_arr-th surviving arrival for each reserved row — the draw
    # mixes the window counter with the row index
    mix = (_mul32(window.long() & _M32, 0x9E3779B1)[:, None]
           + _mul32(j, 0x85EBCA77)[None, :]) & _M32
    pick = torch.floor(hash01(mix, _SALT_INJECT, cfg)
                       * n_arr.to(torch.float32)[:, None]).to(torch.int32)
    pick = torch.minimum(pick.clamp_min(0),
                         (n_arr - 1).clamp_min(0)[:, None])
    cum = torch.cumsum(arrive.to(torch.int32), -1, dtype=torch.int32)
    src = torch.searchsorted(cum, (pick + 1).contiguous()).clamp(0, E - 1)

    # fresh ids round-robin through the reserved pool: distinct within a
    # window (pool >= S is validated by SimConfig), wrapping across windows
    pool = cfg.resolved_inject_task_slots
    islot = cfg.real_task_slots + torch.remainder(
        window[:, None] * S + j[None, :].to(torch.int32), pool)

    def put(col, new):
        cur = col[:, E - S:]
        mask = active.view((B, S) + (1,) * (cur.dim() - 2))
        return torch.cat([col[:, :E - S], torch.where(mask, new, cur)],
                         dim=1)

    return w._replace(
        kind=put(w.kind, torch.full_like(w.kind[:, E - S:],
                                         int(EventKind.ADD_TASK))),
        slot=put(w.slot, islot.to(w.slot.dtype)),
        a=put(w.a, take(w.a, src)),
        u=put(w.u, take(w.u, src)),
        prio=put(w.prio, take(w.prio, src)),
        job=put(w.job, take(w.job, src)),
        constraints=put(w.constraints, take(w.constraints, src)),
        attr_idx=put(w.attr_idx, take(w.attr_idx, src)),
        attr_val=put(w.attr_val, take(w.attr_val, src)),
        t_off=put(w.t_off, take(w.t_off, src)),
    )


def expire_injected(state: SimState, k: ScenarioKnobs, cfg: SimConfig
                    ) -> SimState:
    """Injected-task lifecycles: synthesised REMOVEs after a sampled duration.

    Each pool slot ``q`` gets a deterministic lifetime ``dur(q)`` in
    ``[1, L-1]`` windows (L = floor(pool / S), the slot-recycle period): the
    clone injected into ``q`` at window ``w0`` is removed — counted as a
    completion — at window ``w0 + dur(q)``. Only live slots of the reserved
    pool are touched, so lanes with ``arrival_rate <= 1`` are a bitwise
    no-op. Updates the task tables in place.
    """
    S = cfg.inject_slots
    pool = cfg.resolved_inject_task_slots
    L = pool // S if S else 0
    if L <= 1:      # pool recycles immediately — no room for a lifetime
        return state
    dev = state.window.device
    q = torch.arange(pool, dtype=torch.int32, device=dev)
    dur = 1 + torch.floor(hash01(q, _SALT_LIFETIME, cfg)
                          * (L - 1)).to(torch.int32)
    dur = dur.clamp(1, L - 1)
    w0 = state.window[:, None] - dur[None, :]          # candidate windows
    injected_then = torch.remainder(q[None, :] - w0 * S, pool) < S
    lo = cfg.real_task_slots
    ts, tn = state.task_state[:, lo:lo + pool], state.task_node[:, lo:lo + pool]
    live = ts != TASK_EMPTY
    victim = (injected_then & (w0 >= 0) & live
              & (k.arrival_rate > 1.0)[:, None])
    n = victim.sum(-1, dtype=torch.int32)
    was_running = victim & (ts == TASK_RUNNING)
    if cfg.incremental_accounting:
        # debit removed *running* clones from their nodes: lanes without
        # victims add nothing, so the lane-0 bitwise identity survives
        rows = tn.clone()
        state = state._replace(
            node_reserved=add_rows(state.node_reserved, rows, was_running,
                                   -state.task_req[:, lo:lo + pool]),
            node_used=add_rows(state.node_used, rows, was_running,
                               -accounted_usage(
                                   state.task_usage[:, lo:lo + pool])))
    ts.masked_fill_(victim, TASK_EMPTY)
    tn.masked_fill_(victim, -1)
    return state._replace(completions=state.completions + n)


def storm_victims(state: SimState, k: ScenarioKnobs, cfg: SimConfig):
    """This window's eviction-storm victims: ((B, T) bool mask, running
    victim-count cumsum or None).

    The draw mixes the window counter with the task slot. When
    ``cfg.resolved_storm_max_victims < max_tasks`` the mask is capped to
    the first V hits in slot order (a *bounded* storm), and the cumsum the
    cap comes from is returned as the compactor's rank index for
    :func:`storm_debit` (uncapped configs return None).
    """
    T = cfg.max_tasks
    slots = torch.arange(T, device=state.window.device)
    mix = (_mul32(slots, 0x9E3779B1)[None, :]
           + _mul32(state.window.long() & _M32, 0x85EBCA77)[:, None]) & _M32
    hit = hash01(mix, _SALT_STORM, cfg) < k.storm_frac[:, None]
    victim = (state.task_state == TASK_RUNNING) & hit
    if cfg.resolved_storm_max_victims >= T:
        return victim, None
    cum = torch.cumsum(victim.to(torch.int32), -1, dtype=torch.int32)
    return victim & (cum <= cfg.resolved_storm_max_victims), cum


def storm_debit(state: SimState, victim: torch.Tensor, cum, cfg: SimConfig
                ) -> SimState:
    """Debit the storm victims' req/usage contributions from the node
    tallies (incremental accounting only).

    Capped storms compact the victim rows first — ``searchsorted`` over the
    victim cumsum finds the j-th victim's row for every compact slot j < V
    — and debit them with one O(B*V) delta scatter. Uncapped configs take
    the masked segment sum (kernel E, one launch for all lanes) over the
    whole task table.
    """
    T = cfg.max_tasks
    V = cfg.resolved_storm_max_victims
    if cum is None:
        R = state.task_req.shape[-1]
        vals = torch.cat([state.task_req,
                          accounted_usage(state.task_usage)], dim=-1)
        sub = segment_usage_lanes(state.task_node, vals, victim,
                                  cfg.max_nodes)
        return state._replace(
            node_reserved=state.node_reserved - sub[..., :R],
            node_used=state.node_used - sub[..., R:])
    B = cum.shape[0]
    ranks = torch.arange(1, V + 1, dtype=cum.dtype, device=cum.device)
    vrows = torch.searchsorted(cum, ranks.expand(B, V).contiguous())
    valid = (torch.arange(V, device=cum.device)[None, :]
             < torch.clamp_max(cum[:, -1], V)[:, None])
    rows = vrows.clamp_max(T - 1)
    vnode = take(state.task_node, rows)
    return state._replace(
        node_reserved=add_rows(state.node_reserved, vnode, valid,
                               -take(state.task_req, rows)),
        node_used=add_rows(state.node_used, vnode, valid,
                           -accounted_usage(take(state.task_usage, rows))))


def storm_evict(state: SimState, k: ScenarioKnobs, cfg: SimConfig) -> SimState:
    """Per-window eviction storm: force a hashed fraction of running tasks
    (up to ``cfg.resolved_storm_max_victims``) back to pending, debiting
    them under incremental accounting. Updates the task tables in place."""
    victim, cum = storm_victims(state, k, cfg)
    n = victim.sum(-1, dtype=torch.int32)
    if cfg.incremental_accounting:
        state = storm_debit(state, victim, cum, cfg)
    state.task_state.masked_fill_(victim, TASK_PENDING)
    state.task_node.masked_fill_(victim, -1)
    return state._replace(evictions=state.evictions + n)
