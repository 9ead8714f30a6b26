"""Gradient compression: int8 quantization with error feedback (EF-SGD
style). A copy of ``repro.distributed.compression`` in PyTorch.

:func:`apply_int8_ef` quantizes the (already reduced) gradient to int8 per
tensor, dequantizes, and carries the quantization residual in an
error-feedback buffer inside the optimizer state. :func:`compressed_psum`,
the int8-over-the-wire collective, waits for the ``distributed/`` slice of
the port.
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


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """int8-over-the-wire psum: a collective over a mesh axis, which waits
    for the ``distributed/`` slice of the port (ROADMAP Queue 1)."""
    raise NotImplementedError(
        "compressed_psum is a collective; it waits for the distributed/ "
        "slice of the port (ROADMAP Queue 1)")
