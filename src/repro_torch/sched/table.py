"""Proposal table — switchless fleet scheduler dispatch.

A scheduler may register a :class:`TableForm`: a parameterised score
transform ``transform(cfg, ctx, rng, params) -> pref (P, N)`` over the
shared ``base_pass`` output of one lane (:class:`SchedContext`), plus the
proposal family (``kernels.placement_commit.FAM_*``) the fused scheduler
kernel derives the same preference from.

* :func:`snapshot_dispatch` (sched.registry) freezes the registry into an
  immutable :class:`DispatchTable` when a fleet is built, so plugins
  registered later cannot retarget its scheduler indices;
* :func:`make_switchless_dispatch` groups the fleet's lanes by proposal
  family from the STATIC per-lane assignment: lanes whose family the
  kernel derives (scores, node order) materialise nothing, each external
  family is evaluated once over only its own lanes, and every lane is
  committed by ONE launch of the fused pass (``sched_commit_fleet``,
  kernel D on the card).

Schedulers without a table form (opaque plugins) stay first-class: a fleet
that names one dispatches through the per-lane proposal path
(``scenarios.batch``), with the same trajectories.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.state import lane
from repro_torch.kernels.placement_commit import (FAM_EXTERNAL,
                                                  FAM_NODE_ORDER, FAM_SCORES)
from repro_torch.kernels.placement_commit.ops import (lane_const,
                                                      sched_commit_fleet)
from repro_torch.sched.base import base_pass
from repro_torch.sched.commit import apply_commit, commit_operands
from repro_torch.trace import span


class SchedContext(NamedTuple):
    """Everything a table-form transform may read: one lane's base-pass
    output plus the state slices the built-in proposals touch (the fleet
    builds it for all lanes at once, a lane axis in front of every field)."""
    idx: torch.Tensor            # (P,) pending task slots, priority-descending
    valid: torch.Tensor          # (P,) bool — slot actually pending
    base_ok: torch.Tensor        # (P, N) bool constraint feasibility
    scores: torch.Tensor         # (P, N) f32 best-fit scores (-inf infeasible)
    req: torch.Tensor            # (P, R) f32 gathered task requests
    node_total: torch.Tensor     # (N, R) f32 capacities
    node_reserved: torch.Tensor  # (N, R) f32 running reservations
    node_active: torch.Tensor    # (N,) bool
    window: torch.Tensor         # () i32 current window index


class TableForm(NamedTuple):
    """A scheduler's proposal-table registration.

    transform: ``(cfg, ctx, rng, params) -> pref (P, N)`` over one lane's
    :class:`SchedContext`; lanes sharing ``(transform, params)`` are
    evaluated together, once. params: static floats. fused: the family code
    the fused kernel derives this family's preferences from
    (``FAM_SCORES`` / ``FAM_NODE_ORDER``); ``FAM_EXTERNAL`` means the
    transform's output is materialised and handed to the kernel."""
    transform: Callable
    params: Tuple[float, ...] = ()
    fused: int = FAM_EXTERNAL


@dataclasses.dataclass(frozen=True)
class DispatchTable:
    """Immutable snapshot of the registry rows a fleet dispatches over.

    Column i describes scheduler ``names[i]``; the fleet's per-lane
    ``sched_idx`` knobs index into exactly this tuple order."""
    names: Tuple[str, ...]
    proposers: Tuple[Callable, ...]
    dynamic: Tuple[bool, ...]
    forms: Tuple[Optional[TableForm], ...]

    @property
    def switchless(self) -> bool:
        """True when every scheduler in the table has a table form — the
        precondition for switchless dispatch."""
        return all(f is not None for f in self.forms)


def context_from_state(state, idx, valid, base_ok, scores) -> SchedContext:
    """Assemble the transform context for one lane's state."""
    return SchedContext(idx=idx, valid=valid, base_ok=base_ok, scores=scores,
                        req=state.task_req[idx],
                        node_total=state.node_total,
                        node_reserved=state.node_reserved,
                        node_active=state.node_active,
                        window=state.window)


# --- built-in transform families ------------------------------------------

def tf_scores(cfg, ctx: SchedContext, rng, params):
    """Greedy/best-fit family: the base-pass score matrix IS the preference
    (fused in-kernel as FAM_SCORES — zero derivation cost)."""
    return ctx.scores


def tf_node_order(cfg, ctx: SchedContext, rng, params):
    """Node-order family: rank nodes by ``-((index - start) % N)`` where
    ``start = (window * rot) % N`` — first-fit at rot=0, round-robin at the
    registered rotation stride (int32 -> f32 casts are exact below 2**24
    nodes)."""
    start = torch.remainder(ctx.window * int(params[0]), cfg.max_nodes)
    order = torch.remainder(
        torch.arange(cfg.max_nodes, device=ctx.base_ok.device) - start,
        cfg.max_nodes)
    return (-order.to(torch.float32))[None, :].expand(ctx.base_ok.shape)


def tf_random(cfg, ctx: SchedContext, rng, params):
    """Uniform random preference draw (rng-derived — external family)."""
    return prng.uniform(rng, ctx.base_ok.shape)


def make_switchless_dispatch(cfg, table: DispatchTable,
                             lane_scheds: Tuple[int, ...]):
    """Build the fleet's batched switchless scheduler pass.

    lane_scheds: the STATIC per-lane scheduler index (lane i runs
    ``table.names[lane_scheds[i]]``), the values the knobs' ``sched_idx``
    column carries. Returns ``dispatch(state_B, rng=None) -> state_B`` over
    the lane-batched fleet state; requires ``table.switchless``.

    One base pass (kernel A) for all lanes; each external family runs its
    transform once per lane of its own sub-batch and is stacked into
    ``ext``; then one fused commit (kernel D) derives the score and
    node-order preferences in the kernel and commits every lane. Every lane
    gets the same window key ``rng``, as the reference's vmapped transform
    does (common random numbers across the what-if lanes).
    """
    assert table.switchless, "opaque scheduler in a switchless dispatch"
    B = len(lane_scheds)
    forms = [table.forms[s] for s in lane_scheds]
    dynamic = tuple(bool(table.dynamic[s]) for s in lane_scheds)
    fam = tuple(f.fused for f in forms)
    rots = tuple(int(f.params[0]) if f.fused == FAM_NODE_ORDER else 0
                 for f in forms)

    # static lane grouping of the external families
    ext_groups = {}              # (transform, params, fused) -> [lane, ...]
    for b, f in enumerate(forms):
        if f.fused == FAM_EXTERNAL:
            ext_groups.setdefault(f, []).append(b)
    ext_row, n_rows = [0] * B, 0
    for lanes in ext_groups.values():
        for b in lanes:
            ext_row[b] = n_rows
            n_rows += 1
    ext_row = tuple(ext_row)

    def dispatch(state_B, rng=None):
        with span("agocs.sched.base"):
            idx, valid, base_ok, scores = base_pass(state_B, cfg)
            total, denom, req = commit_operands(state_B, cfg, idx)
        ext = None
        if ext_groups:
            with span("agocs.sched.external"):
                ctx = SchedContext(idx=idx, valid=valid, base_ok=base_ok,
                                   scores=scores, req=req,
                                   node_total=state_B.node_total,
                                   node_reserved=state_B.node_reserved,
                                   node_active=state_B.node_active,
                                   window=state_B.window)
                ext = torch.stack([
                    form.transform(cfg, lane(ctx, b), rng, form.params)
                    for form, lanes in ext_groups.items() for b in lanes])
        with span("agocs.sched.commit"):
            start = torch.remainder(
                state_B.window * lane_const(rots, state_B.window.device),
                cfg.max_nodes)
            node_of, tally = sched_commit_fleet(
                scores, base_ok, req, valid, total, denom,
                state_B.node_reserved, start, fam=fam, dynamic=dynamic,
                ext=ext, ext_row=ext_row, tile_p=cfg.commit_tile_p or None,
                tile_n=cfg.commit_tile_n or None)
            return apply_commit(state_B, cfg, idx, node_of, tally)

    return dispatch


__all__ = ["SchedContext", "TableForm", "DispatchTable", "FAM_EXTERNAL",
           "FAM_NODE_ORDER", "FAM_SCORES", "context_from_state", "tf_scores",
           "tf_node_order", "tf_random", "make_switchless_dispatch"]
