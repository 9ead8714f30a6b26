"""Shared building blocks: param-definition table, RMSNorm, SwiGLU, RoPE.

Copies of ``repro.models.layers`` in PyTorch. Every block module exposes
``param_defs(cfg) -> {name: ParamDef}`` and an ``apply`` function; one
definition table drives initialisation and the shape checks of
``model.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import logical_constraint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype string (``"bfloat16"``) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones
    scale: Optional[float] = None   # stddev; None -> 1/sqrt(fan_in) (first dim)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_from_defs(generator: torch.Generator, defs: Dict[str, ParamDef],
                   dtype=torch.float32, repeats: Optional[int] = None,
                   device=None) -> Dict[str, torch.Tensor]:
    """One tensor per def, in sorted name order, drawn from ``generator``
    (on the generator's device, then moved to ``device``): normal x
    ``scale`` (or 1/sqrt of the first dim), zeros or ones. ``repeats``
    stacks R independent draws on a leading axis."""
    lead = () if repeats is None else (repeats,)
    device = generator.device if device is None else device
    out = {}
    for name, d in sorted(defs.items()):
        shape = lead + tuple(d.shape)
        if d.init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif d.init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            scale = (d.scale if d.scale is not None
                     else 1.0 / math.sqrt(max(d.shape[0], 1)))
            x = torch.randn(shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            out[name] = x.mul_(scale).to(device=device, dtype=dtype)
    return out


def axes_from_defs(defs: Dict[str, ParamDef]
                   ) -> Dict[str, Tuple[Optional[str], ...]]:
    return {name: d.axes for name, d in defs.items()}


# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def swiglu(x: torch.Tensor) -> torch.Tensor:
    """Fused gate|up layout: last dim is 2*ff -> silu(gate) * up."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up


# --- RoPE ------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int. The half-split rotation,
    angles in f32, the result cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- dense SwiGLU MLP ------------------------------------------------------


def mlp_param_defs(cfg) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamDef((d, 2 * ff), ("embed", "ff")),
        "wo": ParamDef((ff, d), ("ff", "embed")),
    }


def mlp_apply(params, cfg, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["wi"].to(x.dtype)
    h = logical_constraint(h, "batch", "seq", "act_ff")
    h = swiglu(h)
    return h @ params["wo"].to(x.dtype)
