"""Dispatch for the commit scan (``csrc/placement_commit.cu``, kernel B) and
the fused scheduler pass (``csrc/sched_commit.cu``, kernel D): CUDA tensors
launch the kernels, CPU tensors take the plain versions.

Lane-batched operands carry a leading lane axis B, or 1 when the lanes
share the operand; a shared operand is passed with lane stride 0, not
copied B times. Both kernels run the scan of ``csrc/commit_scan.cuh``: one
thread-block cluster per lane, the node axis split among its blocks, so
they take any N and R the reference takes.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.placement_commit import (FAM_EXTERNAL,
                                                  FAM_NODE_ORDER, FAM_SCORES)
from repro_torch.kernels.placement_commit.ref import (placement_commit_ref,
                                                      sched_commit_fleet_ref)

__all__ = ["FAM_EXTERNAL", "FAM_NODE_ORDER", "FAM_SCORES", "MODES",
           "cluster_size", "lane_const", "placement_commit",
           "placement_commit_cuda", "sched_commit_cuda", "sched_commit_fleet",
           "sched_pass"]

MODES = ("static", "dynamic", "both")


def cluster_size(kernel: str, lanes: int, R: int = 3) -> int:
    """Blocks a lane's cluster has when ``kernel`` ('placement_commit' or
    'sched_commit') runs over ``lanes`` lanes with R resources on the
    current card: 16 or 8, whichever the card keeps resident in fewer waves
    (``pick_cluster`` in ``csrc/commit_scan.cuh``)."""
    if kernel not in ("placement_commit", "sched_commit"):
        raise ValueError(f"no cluster scan in {kernel!r}")
    c = getattr(_build.library(), f"{kernel}_cluster")(int(lanes), int(R))
    if c < 0:
        raise RuntimeError(f"{kernel}_cluster: CUDA error {-c}")
    return c


def _lane_operands(named, B: Optional[int] = None):
    """Check the scan's lane operands ((name, tensor, dtype, tail shape),
    in the kernels' OP_* order) -> (B, lane-broadcast bit mask); B is the
    largest lane axis unless given."""
    if B is None:
        B = max(t.shape[0] for _, t, _, _ in named)
    bcast = 0
    for i, (name, t, dtype, tail) in enumerate(named):
        lanes = t.shape[0]
        if lanes not in (1, B):
            raise ValueError(f"{name}: lane axis {lanes}, expected 1 or {B}")
        _build.check(t, name, dtype, (lanes,) + tuple(tail))
        if lanes == 1 and B > 1:
            bcast |= 1 << i
    return B, bcast


def _scan_operands(first, first_name, req, ok, valid, total, denom,
                   reserved0, B: Optional[int] = None):
    P, N = first.shape[1], first.shape[2]
    R = req.shape[2]
    B, bcast = _lane_operands([
        (first_name, first, torch.float32, (P, N)),
        ("req", req, torch.float32, (P, R)),
        ("ok", ok, torch.bool, (P, N)),
        ("valid", valid, torch.bool, (P,)),
        ("total", total, torch.float32, (N, R)),
        ("denom", denom, torch.float32, (N, R)),
        ("reserved0", reserved0, torch.float32, (N, R))], B)
    return (B, bcast), (P, N, R)


def _tally0(reserved0: torch.Tensor, B: int) -> torch.Tensor:
    """The kernels' tally operand: a fresh (B, N, R) copy of reserved0,
    which the scan updates in place (never the caller's tensor)."""
    tally = torch.empty((B,) + tuple(reserved0.shape[1:]),
                        dtype=torch.float32, device=reserved0.device)
    return tally.copy_(reserved0.expand_as(tally))


def placement_commit_cuda(pref, req, ok, valid, total, denom, reserved0,
                          mode: str, dyn: Optional[torch.Tensor] = None):
    """Kernel B over a leading lane axis B (1 for the single-trajectory
    engine; 1 on any operand the lanes share): pref (B,P,N) f32, req
    (B,P,R) f32, ok (B,P,N) bool, valid (B,P) bool, total/denom/reserved0
    (B,N,R) f32 -> (node_of (B,P) i32, tally (B,N,R) f32). ``mode`` is
    'static' (score = pref), 'dynamic' (re-score against the running tally;
    pref is not read) or 'both' (``dyn`` (B,) bool picks per lane)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    (B, bcast), (P, N, R) = _scan_operands(pref, "pref", req, ok, valid,
                                           total, denom, reserved0)
    if mode == "both":
        _build.check(dyn, "dyn", torch.bool, (B,))
    else:
        dyn = None
    node_of = torch.empty((B, P), dtype=torch.int32, device=pref.device)
    tally = _tally0(reserved0, B)
    _build.launch("placement_commit_launch", pref, req, ok, valid, total,
                  denom, dyn, node_of, tally, B, P, N, R,
                  int(mode == "dynamic"), bcast)
    placement_commit_cuda.launches += 1
    return node_of, tally


placement_commit_cuda.launches = 0


def placement_commit(pref, req, base_ok, valid, total, denom, reserved0,
                     dynamic_bestfit=False, *, return_tally: bool = False):
    """Sequential capacity-checked assignment in priority (row) order.

    pref (P,N) f32 preference scores, req (P,R) f32 requests, base_ok (P,N)
    bool feasibility, valid (P,) bool, total (N,R) f32 with inactive nodes
    folded to -1, denom (N,R) f32 best-fit normaliser, reserved0 (N,R) f32
    starting tally -> node_of (P,) i32 (-1 = not placed); with
    ``return_tally=True`` -> (node_of, reserved (N,R) f32), the scan's final
    tally, which incremental accounting adopts as node_reserved.

    Every operand may carry a leading lane axis B (or 1, shared by the
    lanes), and then so do the results. ``dynamic_bestfit`` is a Python
    bool (one mode for every lane), or a bool tensor with one flag per lane
    (mode 'both', the scenario fleet's switch dispatch).
    """
    args = (pref, req, base_ok, valid, total, denom, reserved0)
    if pref.dim() == 2:
        flag = dynamic_bestfit
        if isinstance(flag, torch.Tensor):
            flag = flag.reshape(1)
        out = placement_commit(*[x[None] for x in args], flag,
                               return_tally=True)
        out = (out[0][0], out[1][0])
        return out if return_tally else out[0]
    B = max(x.shape[0] for x in args)
    per_lane = isinstance(dynamic_bestfit, torch.Tensor)
    if per_lane:
        if dynamic_bestfit.shape != (B,):
            raise ValueError(f"per-lane dynamic_bestfit: shape "
                             f"{tuple(dynamic_bestfit.shape)}, expected "
                             f"({B},)")
    elif not isinstance(dynamic_bestfit, bool):
        raise TypeError("dynamic_bestfit must be a Python bool or a bool "
                        "tensor with one flag per lane")
    if pref.device.type == "cuda":
        if per_lane:
            out = placement_commit_cuda(
                *(x.contiguous() for x in args), "both",
                dynamic_bestfit.to(torch.bool).contiguous())
        else:
            out = placement_commit_cuda(
                *(x.contiguous() for x in args),
                "dynamic" if dynamic_bestfit else "static")
    else:
        lanes = [placement_commit_ref(
            *[x[b if x.shape[0] > 1 else 0] for x in args],
            dynamic_bestfit[b] if per_lane else dynamic_bestfit)
            for b in range(B)]
        out = tuple(torch.stack(f) for f in zip(*lanes))
    return out if return_tally else out[0]


def sched_commit_cuda(scores, req, ok, valid, total, denom, reserved0, ext,
                      lane_params):
    """Kernel D over a leading lane axis B (1 on any operand the lanes
    share): scores (B,P,N) f32, req (B,P,R), ok (B,P,N) bool, valid (B,P)
    bool, total/denom/reserved0 (B,N,R) f32, ext (BE,P,N) f32 or None,
    lane_params (B,4) i32 rows (fam, dyn, start, ext_row) -> (node_of (B,P)
    i32, tally (B,N,R) f32)."""
    B = lane_params.shape[0]
    (B, bcast), (P, N, R) = _scan_operands(scores, "scores", req, ok, valid,
                                           total, denom, reserved0, B)
    _build.check(lane_params, "lane_params", torch.int32, (B, 4))
    if ext is not None:
        _build.check(ext, "ext", torch.float32, (ext.shape[0], P, N))
    node_of = torch.empty((B, P), dtype=torch.int32, device=scores.device)
    tally = _tally0(reserved0, B)
    _build.launch("sched_commit_launch", scores, req, ok, valid, total,
                  denom, ext, lane_params, node_of, tally, B, P, N, R,
                  bcast)
    sched_commit_cuda.launches += 1
    return node_of, tally


sched_commit_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def lane_const(values: tuple, device: torch.device) -> torch.Tensor:
    """A small int32 tensor of static per-lane values, made once per
    device (a host-to-device copy per call would synchronise)."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def sched_commit_fleet(scores, ok, req, valid, total, denom, reserved0,
                       start, *, fam: Sequence[int],
                       dynamic: Sequence[bool], ext=None,
                       ext_row: Optional[Sequence[int]] = None,
                       tile_p: Optional[int] = None,
                       tile_n: Optional[int] = None):
    """Mixed-family fused pass for the switchless scenario fleet, every
    operand with a lane axis B (or 1, shared).

    scores/ok (B,P,N), req (B,P,R), valid (B,P), total/denom/reserved0
    (B,N,R), start (B,) i32 per-lane node-order rotations; ``fam`` /
    ``dynamic`` / ``ext_row`` static per-lane tuples; ``ext`` (BE,P,N)
    stacks the evaluated prefs of the external lanes, lane b reading row
    ``ext_row[b]``. Returns (node_of (B,P) i32, tally (B,N,R) f32), lane for
    lane what ``sched_pref_ref -> placement_commit_ref`` gives. ``tile_p``
    and ``tile_n`` (the reference kernel's VMEM tiles) are accepted and
    ignored: the kernel's cluster splits any node row among its blocks.
    """
    B = len(fam)
    ext_row = tuple(ext_row) if ext_row is not None else (0,) * B
    if len(dynamic) != B or len(ext_row) != B:
        raise ValueError("fam, dynamic and ext_row need one entry per lane")
    if any(f not in (FAM_EXTERNAL, FAM_SCORES, FAM_NODE_ORDER) for f in fam):
        raise ValueError(f"unknown proposal family in {tuple(fam)}")
    if any(f == FAM_EXTERNAL for f in fam):
        if ext is None:
            raise ValueError("FAM_EXTERNAL lanes need the evaluated ext")
        if any(f == FAM_EXTERNAL and not 0 <= r < ext.shape[0]
               for f, r in zip(fam, ext_row)):
            raise ValueError(f"ext_row {ext_row} outside ext's "
                             f"{ext.shape[0]} rows")
    start = torch.as_tensor(start, dtype=torch.int32,
                            device=scores.device).reshape(-1)
    start = start.expand(B) if start.shape[0] == 1 else start
    if scores.device.type == "cuda":
        args = (req, ok, valid, total, denom, reserved0)
        dev = scores.device
        lane_params = torch.stack([
            lane_const(tuple(int(f) for f in fam), dev),
            lane_const(tuple(int(bool(d)) for d in dynamic), dev),
            start, lane_const(ext_row, dev)], dim=1).contiguous()
        return sched_commit_cuda(
            scores.contiguous(), *(x.contiguous() for x in args),
            None if ext is None else ext.contiguous(), lane_params)
    return sched_commit_fleet_ref(scores, ok, req, valid, total, denom,
                                  reserved0, start, fam, dynamic, ext,
                                  ext_row)


def sched_pass(scores, req, base_ok, valid, total, denom, reserved0,
               dynamic_bestfit: bool = False, *, family: int = FAM_SCORES,
               start=0, ext=None, tile_p: Optional[int] = None,
               tile_n: Optional[int] = None, return_tally: bool = False):
    """Fused proposal+commit for ONE lane and one proposal family: the
    contract of :func:`placement_commit` with ``pref`` replaced by (scores,
    family, start[, ext]) — see :func:`sched_commit_fleet`."""
    node_of, tally = sched_commit_fleet(
        scores[None], base_ok[None], req[None], valid[None], total[None],
        denom[None], reserved0[None], start, fam=(family,),
        dynamic=(bool(dynamic_bestfit),),
        ext=None if ext is None else ext[None])
    out = (node_of[0], tally[0])
    return out if return_tally else out[0]
