"""Simulation state: the reference's structure-of-arrays ``SimState`` as a
NamedTuple of tensors.

Field names, shapes and dtypes are the reference's (``task_state`` int8,
``task_node`` int32 with -1 for unplaced, ...); indices are widened to int64
only where they are used. The engine updates the task tables in place (they
are the large ones), so a state handed to ``run_windows`` or ``Simulation``
belongs to it from then on.

The engine works on *lane-batched* states, every field with a leading lane
axis B (the scenario fleet's worlds; B=1 for the single trajectory).
:func:`lift` and :func:`drop` move between the two forms with views, so an
in-place update through a lifted state lands in the original tables.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.config import SimConfig

TASK_EMPTY, TASK_PENDING, TASK_RUNNING = 0, 1, 2


class SimState(NamedTuple):
    # --- nodes ---
    node_active: torch.Tensor      # (N,)   bool
    node_total: torch.Tensor       # (N,R)  f32 capacity
    node_attrs: torch.Tensor       # (N,K)  i32 attribute values (0 = unset)
    node_reserved: torch.Tensor    # (N,R)  f32 sum of requested res of placed tasks
    node_used: torch.Tensor        # (N,R)  f32 sum of actual usage of placed tasks
    # --- tasks (slotted table) ---
    task_state: torch.Tensor       # (T,)   i8
    task_req: torch.Tensor         # (T,R)  f32 requested resources
    task_usage: torch.Tensor       # (T,U)  f32 fine-grained usage stats
    task_node: torch.Tensor        # (T,)   i32 (-1 = unplaced)
    task_prio: torch.Tensor        # (T,)   i32
    task_job: torch.Tensor         # (T,)   i32
    task_constraints: torch.Tensor # (T,C,3) i32 (attr_idx, op, value)
    # --- counters ---
    window: torch.Tensor           # ()     i32
    evictions: torch.Tensor        # ()     i32 cumulative (incl. node-removal evictions)
    completions: torch.Tensor      # ()     i32
    placements: torch.Tensor       # ()     i32
    overflow_drops: torch.Tensor   # ()     i32 pending tasks that never fit


def lift(state):
    """A lane axis of size 1 in front of every field (views)."""
    return type(state)(*[x.unsqueeze(0) for x in state])


def drop(state):
    """The single lane of a B=1 state (views)."""
    return type(state)(*[x.squeeze(0) for x in state])


def lane(state, b: int):
    """Lane ``b`` of a lane-batched state or tuple (views)."""
    return type(state)(*[x[b] for x in state])


def init_state(cfg: SimConfig, device) -> SimState:
    N, T = cfg.max_nodes, cfg.max_tasks
    R, U, K, C = (cfg.n_resources, cfg.n_usage_stats, cfg.n_attr_slots,
                  cfg.max_constraints)
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SimState(
        node_active=z((N,), torch.bool),
        node_total=z((N, R), f32),
        node_attrs=z((N, K), i32),
        node_reserved=z((N, R), f32),
        node_used=z((N, R), f32),
        task_state=z((T,), torch.int8),
        task_req=z((T, R), f32),
        task_usage=z((T, U), f32),
        task_node=torch.full((T,), -1, dtype=i32, device=device),
        task_prio=z((T,), i32),
        task_job=z((T,), i32),
        task_constraints=z((T, C, 3), i32),
        window=z((), i32),
        evictions=z((), i32),
        completions=z((), i32),
        placements=z((), i32),
        overflow_drops=z((), i32),
    )


def state_from_numpy(d: Dict[str, np.ndarray], device) -> SimState:
    """A reference state given as ``{field: numpy array}`` (e.g.
    ``{k: np.asarray(v) for k, v in ref_state._asdict().items()}``) as the
    port's state on ``device``, dtypes unchanged."""
    return SimState(**{f: torch.as_tensor(np.array(d[f], copy=True)).to(device)
                       for f in SimState._fields})


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """The port's state as ``{field: numpy array}`` on the host."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in SimState._fields}


def validate_invariants(state: SimState, cfg: SimConfig) -> dict:
    """Host-side invariant checks (tests + paused-simulation inspection):

    * running tasks point at active nodes;
    * node_reserved equals the segment-sum of requested resources of the
      running tasks placed on each node (and never exceeds capacity);
    * pending tasks are unplaced.
    """
    s = state_to_numpy(state)
    running = s["task_state"] == TASK_RUNNING
    pending = s["task_state"] == TASK_PENDING
    task_node, node_active = s["task_node"], s["node_active"]
    problems = {}
    if running.any():
        nodes = task_node[running]
        if (nodes < 0).any() or not node_active[nodes].all():
            problems["running_on_inactive"] = int(
                (~node_active[np.maximum(nodes, 0)]).sum())
    if (task_node[pending] != -1).any():
        problems["pending_placed"] = int((task_node[pending] != -1).sum())
    reserved = np.zeros_like(s["node_reserved"])
    np.add.at(reserved, task_node[running], s["task_req"][running])
    if not np.allclose(reserved, s["node_reserved"], atol=1e-3):
        problems["reserved_mismatch"] = float(
            np.abs(reserved - s["node_reserved"]).max())
    over = s["node_reserved"] > s["node_total"] + 1e-5
    if over.any():
        problems["overcommit"] = int(over.sum())
    return problems
