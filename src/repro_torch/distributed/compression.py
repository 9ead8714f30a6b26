"""Gradient compression: int8 quantization with error feedback (EF-SGD
style). A copy of ``repro.distributed.compression`` in PyTorch.

:func:`apply_int8_ef` quantizes the (already reduced) gradient to int8 per
tensor, dequantizes, and carries the quantization residual in an
error-feedback buffer inside the optimizer state. :func:`compressed_psum`
is the wire-accurate version, run inside a ``local_map`` region: each rank
quantizes its local partial gradient to int8, the int8 payload (plus an
f32 scale) is summed across a mesh axis, and the result is dequantized.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.train.tree import map_tree


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def apply_int8_ef(grads, opt_state):
    """Returns (dequantized grads, opt_state with updated ef buffers)."""
    ef = opt_state.ef
    if ef is None:
        ef = map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)

    def one(g, e):
        corrected = g.float() + e
        q, s = _quantize(corrected)
        deq = _dequantize(q, s)
        return deq, corrected - deq

    outs = map_tree(one, grads, ef)
    deq = map_tree(lambda g, o: o[0], grads, outs)
    new_ef = map_tree(lambda g, o: o[1], grads, outs)
    return deq, opt_state._replace(ef=new_ef)


def compressed_psum(x: torch.Tensor, axis_name: str,
                    mesh=None) -> torch.Tensor:
    """int8-over-the-wire psum of the local ``x`` over the ranks of mesh
    axis ``axis_name`` (of ``mesh``; default: the mesh of the active
    ``axis_rules``): a MAX all_reduce agrees the scale, the int8 payload
    is summed in int32 (no overflow up to ~16M ranks), and one multiply
    dequantizes."""
    import torch.distributed as dist
    if mesh is None:
        from repro_torch.distributed.sharding import _current
        mesh, _ = _current()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh: pass mesh= or run "
                         "under axis_rules")
    group = mesh.get_group(axis_name)
    scale = x.abs().max() / 127.0 + 1e-12
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale
