"""AdamW with warmup-cosine schedule and global-norm clipping.

A copy of ``repro.train.optim`` in PyTorch. Optimizer state mirrors the
parameter tree leaf for leaf. The reference is functional; here the update
runs in place, on slices of at most ``CHUNK`` elements, so that a step at
full width (a stacked MLP leaf of qwen3-4b is 7.2 GB in f32) builds no
leaf-sized temporaries: :func:`clip_by_global_norm` scales the gradients in
place, :func:`adamw_update` overwrites the parameters, the gradients and
both moments and returns them. The order of arithmetic is the reference's.

On a mesh the leaves are DTensors with the same placements (params, grads
and both moments, ``distributed.placement.opt_shardings``): the update is
elementwise, so it runs on each rank's local block, and the global norm
sums each block's squares and then adds them over the mesh dims that
split the leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.train.tree import leaves, map_tree

CHUNK = 1 << 26                  # elements per in-place slice (256 MB f32)


class OptState(NamedTuple):
    step: torch.Tensor    # scalar int32
    mu: Any               # first moment, like params
    nu: Any               # second moment, like params
    ef: Any = None        # error-feedback buffers (grad compression), optional


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (the same storage); a tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def init_opt_state(params, with_ef: bool = False) -> OptState:
    def zeros(p):
        if hasattr(p, "to_local"):          # a DTensor: the same placements
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = leaves(params)[0]
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    mu=map_tree(zeros, params), nu=map_tree(zeros, params),
                    ef=map_tree(zeros, params) if with_ef else None)


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps) /
                       max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def _slices(t: torch.Tensor):
    return t.view(-1).split(CHUNK)


def global_norm(tree) -> torch.Tensor:
    sq = 0
    for x in leaves(tree):
        s = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in _slices(_local(x)):
            c = c.float()
            s = s + torch.dot(c, c)
        sq = sq + _sum_over_blocks(x, s)
    return torch.sqrt(sq)


def _sum_over_blocks(x, s: torch.Tensor) -> torch.Tensor:
    """``s``, a sum over x's local block, summed over the mesh dims that
    split x (as it is for a plain tensor or an unsplit DTensor)."""
    if not hasattr(x, "to_local"):
        return s
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    pls = [Partial() if isinstance(p, Shard) else Replicate()
           for p in x.placements]
    if not any(isinstance(p, Partial) for p in pls):
        return s
    return DTensor.from_local(s, x.device_mesh, pls,
                              run_check=False).full_tensor()


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scales the (f32) gradients in place by min(1, max_norm / (norm +
    1e-9)); returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves(grads):
        if g.dtype != torch.float32:
            raise TypeError("clip_by_global_norm scales f32 gradients in "
                            f"place, got {g.dtype}")
        _local(g).mul_(scale)
    return grads, norm


def adamw_update(params, grads, state: OptState, tc: TrainConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: returns (params, OptState(step + 1, mu,
    nu), metrics) with params, mu and nu the same tensors, updated. As in
    the reference, the returned state carries no ``ef``."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(_local(step), tc)
    b1, b2 = tc.b1, tc.b2
    bc1 = 1.0 - torch.pow(b1, _local(step).float())
    bc2 = 1.0 - torch.pow(b2, _local(step).float())

    def upd_(p, g, m, v):
        m.mul_(b1).add_(g * (1 - b1))                # b1 m + (1 - b1) g
        v.mul_(b2).add_(g.square().mul_(1 - b2))     # b2 v + (1 - b2) g^2
        den = (v / bc2).sqrt_().add_(tc.eps)         # sqrt(vhat) + eps
        delta = (m / bc1).div_(den).add_(tc.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))                   # p - lr delta
        else:
            p.copy_(p.float() - delta.mul_(lr))

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        for sl in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            upd_(*sl)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.mu, state.nu), metrics
