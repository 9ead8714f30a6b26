"""Dispatch for the placement-commit kernel: CUDA tensors launch
``csrc/placement_commit.cu``, CPU tensors take the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.placement_commit.ref import placement_commit_ref

MODES = ("static", "dynamic")
#: the largest N*R tally one block's shared memory holds (227 KB)
MAX_TALLY_FLOATS = 232_448 // 4


def placement_commit_cuda(pref, req, ok, valid, total, denom, reserved0,
                          mode: str):
    """The kernel itself, over a leading lane axis B (1 for the
    single-trajectory engine): pref (B,P,N) f32, req (B,P,R) f32, ok (B,P,N)
    bool, valid (B,P) bool, total/denom/reserved0 (B,N,R) f32 -> (node_of
    (B,P) i32, tally (B,N,R) f32). ``mode`` is 'static' (score = pref) or
    'dynamic' (re-score against the running tally; pref is not read)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: the commit kernel builds {MODES}; "
                         "the per-lane flag ('both') belongs to the "
                         "scenario fleet, not ported yet")
    B, P, N = pref.shape
    R = req.shape[2]
    if N * R > MAX_TALLY_FLOATS:
        raise ValueError(f"N*R={N * R} floats do not fit one block's shared "
                         f"memory ({MAX_TALLY_FLOATS})")
    _build.check(pref, "pref", torch.float32, (B, P, N))
    _build.check(req, "req", torch.float32, (B, P, R))
    _build.check(ok, "ok", torch.bool, (B, P, N))
    _build.check(valid, "valid", torch.bool, (B, P))
    for name, t in (("total", total), ("denom", denom),
                    ("reserved0", reserved0)):
        _build.check(t, name, torch.float32, (B, N, R))
    node_of = torch.empty((B, P), dtype=torch.int32, device=pref.device)
    tally = torch.empty((B, N, R), dtype=torch.float32, device=pref.device)
    _build.launch("placement_commit_launch", pref, req, ok, valid, total,
                  denom, reserved0, node_of, tally, B, P, N, R,
                  int(mode == "dynamic"))
    placement_commit_cuda.launches += 1
    return node_of, tally


placement_commit_cuda.launches = 0


def placement_commit(pref, req, base_ok, valid, total, denom, reserved0,
                     dynamic_bestfit: bool = False, *,
                     return_tally: bool = False):
    """Sequential capacity-checked assignment in priority (row) order.

    pref (P,N) f32 preference scores, req (P,R) f32 requests, base_ok (P,N)
    bool feasibility, valid (P,) bool, total (N,R) f32 with inactive nodes
    folded to -1, denom (N,R) f32 best-fit normaliser, reserved0 (N,R) f32
    starting tally -> node_of (P,) i32 (-1 = not placed); with
    ``return_tally=True`` -> (node_of, reserved (N,R) f32), the scan's final
    tally, which incremental accounting adopts as node_reserved.
    ``dynamic_bestfit`` is a Python bool here: the per-lane traced flag
    waits for the scenario fleet.
    """
    if not isinstance(dynamic_bestfit, bool):
        raise TypeError("dynamic_bestfit must be a Python bool (a per-lane "
                        "flag belongs to the scenario fleet, not ported yet)")
    if pref.device.type == "cuda":
        mode = "dynamic" if dynamic_bestfit else "static"
        node_of, tally = placement_commit_cuda(
            *(x.contiguous()[None] for x in
              (pref, req, base_ok, valid, total, denom, reserved0)), mode)
        out = (node_of[0], tally[0])
    else:
        out = placement_commit_ref(pref, req, base_ok, valid, total, denom,
                                   reserved0, dynamic_bestfit)
    return out if return_tally else out[0]
