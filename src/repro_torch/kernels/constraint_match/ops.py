"""Dispatch for the constraint-match kernel: CUDA tensors launch
``csrc/constraint_match.cu``, CPU tensors take the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraint_match.ref import constraint_match_ref


def constraint_match_cuda(req: torch.Tensor, cons: torch.Tensor,
                          total: torch.Tensor, reserved: torch.Tensor,
                          attrs: torch.Tensor, active: torch.Tensor
                          ) -> torch.Tensor:
    """The kernel itself, over a leading lane axis B: req (B,P,R) f32,
    cons (B,P,C,3) i32, total (B,N,R) f32, reserved (B,N,R) f32, attrs
    (B,N,K) i32, active (B,N) bool -> (B,P,N) f32 scores."""
    B, P, R = req.shape
    N, K = attrs.shape[1:]
    C = cons.shape[2]
    _build.check(req, "req", torch.float32, (B, P, R))
    _build.check(cons, "cons", torch.int32, (B, P, C, 3))
    _build.check(total, "total", torch.float32, (B, N, R))
    _build.check(reserved, "reserved", torch.float32, (B, N, R))
    _build.check(attrs, "attrs", torch.int32, (B, N, K))
    _build.check(active, "active", torch.bool, (B, N))
    out = torch.empty((B, P, N), dtype=torch.float32, device=req.device)
    _build.launch("constraint_match_launch", req, cons, total, reserved,
                  attrs, active, out, B, P, N, R, C, K)
    constraint_match_cuda.launches += 1
    return out


constraint_match_cuda.launches = 0


def constraint_match(req, cons, node_total, node_reserved, node_attrs,
                     node_active) -> torch.Tensor:
    """(P, N) f32 scores with -inf for infeasible pairs. Shapes: req (P,R),
    cons (P,C,3), node_* (N,...); or each with a leading lane axis B, giving
    (B, P, N) from one launch."""
    args = (req, cons, node_total, node_reserved, node_attrs, node_active)
    if req.dim() == 2:
        return constraint_match(*[x[None] for x in args])[0]
    if req.device.type != "cuda":
        return torch.stack([constraint_match_ref(*[x[b] for x in args])
                            for b in range(req.shape[0])])
    return constraint_match_cuda(*(x.contiguous() for x in args))
