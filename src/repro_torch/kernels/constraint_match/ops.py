"""Dispatch for the constraint-match kernel: CUDA tensors launch
``csrc/constraint_match.cu``, CPU tensors take the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraint_match.ref import constraint_match_ref


def constraint_match_cuda(req: torch.Tensor, cons: torch.Tensor,
                          total: torch.Tensor, reserved: torch.Tensor,
                          attrs: torch.Tensor) -> torch.Tensor:
    """The kernel itself: req (P,R) f32, cons (P,C,3) i32, total (N,R) f32
    with dead nodes already folded to -1, reserved (N,R) f32, attrs (N,K)
    i32 -> (P,N) f32 scores."""
    P, R = req.shape
    N, K = attrs.shape
    C = cons.shape[1]
    _build.check(req, "req", torch.float32, (P, R))
    _build.check(cons, "cons", torch.int32, (P, C, 3))
    _build.check(total, "total", torch.float32, (N, R))
    _build.check(reserved, "reserved", torch.float32, (N, R))
    _build.check(attrs, "attrs", torch.int32, (N, K))
    out = torch.empty((P, N), dtype=torch.float32, device=req.device)
    _build.launch("constraint_match_launch", req, cons, total, reserved,
                  attrs, out, P, N, R, C, K)
    constraint_match_cuda.launches += 1
    return out


constraint_match_cuda.launches = 0


def constraint_match(req, cons, node_total, node_reserved, node_attrs,
                     node_active) -> torch.Tensor:
    """(P, N) f32 scores with -inf for infeasible pairs. Shapes: req (P,R),
    cons (P,C,3), node_* (N,...)."""
    if req.device.type != "cuda":
        return constraint_match_ref(req, cons, node_total, node_reserved,
                                    node_attrs, node_active)
    # fold node_active into capacity: inactive nodes can never fit any task
    total = torch.where(node_active[:, None], node_total, -1.0)
    return constraint_match_cuda(req.contiguous(), cons.contiguous(), total,
                                 node_reserved.contiguous(),
                                 node_attrs.contiguous())
