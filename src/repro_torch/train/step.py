"""train_step: microbatched gradient accumulation + remat + AdamW.

A copy of ``repro.train.step`` in PyTorch. The step is a plain function
over the parameter tree and :class:`~repro_torch.train.optim.OptState`;
it updates both in place and returns them.

Autograd does not run on the stacked leaves themselves. Each block leaf is
stacked over the R repeats, and a layer reads ``w[r]``: the backward of
that slice would write a zero tensor of the whole stack (7.2 GB for
qwen3-4b's ``wi``) once per repeat, and ``unbind`` would hold all R slice
gradients until it stacked them. So the step trains on per-repeat leaves
(per-codebook for ``embed``) that are views of the stacked storage, and
gives each view's ``.grad`` a view of one stacked gradient buffer, zeroed
in place before each step: autograd then adds every slice's gradient into
the buffer as soon as it exists. The gradient tree the optimizer sees is
that buffer, in the reference's layout; with f32 parameters (every
config) it is the reference's f32 accumulation over microbatches.

On a mesh (parameters placed as DTensors, the step run under
``distributed.sharding.axis_rules``) the same holds on each rank's local
block: the per-repeat leaves are DTensors made from views of the local
stacked storage, and their gradients from views of the local buffer.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import logical_constraint, split_dim
from repro_torch.models import model
from repro_torch.models.layers import torch_dtype
from repro_torch.train import optim
from repro_torch.train.tree import leaves, map_tree


def _microbatch(batch: Dict[str, torch.Tensor], m: int
                ) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (m, B/m, ...) for every leaf. A batch dim split over
    more ranks than divide m is gathered first (``sharding.split_dim``);
    :func:`_rows` splits each microbatch again."""
    return {k: split_dim(x, 0, (m, x.shape[0] // m) + tuple(x.shape[1:]))
            for k, x in batch.items()}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A microbatch leaf with its rows laid out as the batch's (split over
    the data axes on a mesh; a gathered batch is split again locally, so
    that nothing downstream, such as the loss's label gather, runs on the
    whole batch)."""
    return logical_constraint(x, "batch", *([None] * (x.dim() - 1)))


def _unbind(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``t``'s slices along dim 0. A DTensor (never split along
    its stack dim) gives DTensors over views of its local storage."""
    if not hasattr(t, "to_local"):
        return list(t.unbind(0))
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed.sharding import contiguous_stride
    if any(isinstance(p, Shard) and p.dim == 0 for p in t.placements):
        raise ValueError("a stacked leaf split along its stack dim")
    pls = [Shard(p.dim - 1) if isinstance(p, Shard) else p
           for p in t.placements]
    shape = t.shape[1:]
    return [DTensor.from_local(v, t.device_mesh, pls, run_check=False,
                               shape=shape, stride=contiguous_stride(shape))
            for v in t.to_local().unbind(0)]


def _split_leaf(p: torch.Tensor, g: torch.Tensor, cast) -> List:
    """Per-index autograd leaves of the stacked ``p`` whose gradients land
    in the matching slices of ``g``."""
    out = []
    for v, gv in zip(_unbind(p.detach()), _unbind(g)):
        v.requires_grad_()
        v.grad = gv
        out.append(cast(v))
    return out


def _whole_leaf(p: torch.Tensor, g: torch.Tensor, cast):
    v = p.detach().requires_grad_()
    v.grad = g
    return cast(v)


def attach_grads(cfg: ModelConfig, params, grads):
    """The tree the model reads in a training step: views of ``params``
    whose gradients accumulate into ``grads`` (same structure). Under
    ``cfg.bf16_weight_gather`` every f32 leaf of two or more dims (counted
    on the stacked leaf, as the reference counts them) is cast to
    ``cfg.dtype`` inside the graph, so its gradient comes back in f32."""
    dt = torch_dtype(cfg.dtype)

    def caster(p):
        if (cfg.bf16_weight_gather and p.dtype == torch.float32
                and p.dim() >= 2):
            return lambda v: v.to(dt)
        return lambda v: v

    out = {}
    for k, sub in params.items():
        if k == "blocks":
            out[k] = map_tree(lambda p, g: _split_leaf(p, g, caster(p)),
                              sub, grads[k])
        elif k == "embed":
            out[k] = _split_leaf(sub, grads[k], caster(sub))
        else:
            out[k] = _whole_leaf(sub, grads[k], caster(sub))
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Build ``train_step(params, opt_state, batch, rng=None)``. The
    gradient buffer is allocated on the first call and reused."""
    held: Dict[str, Any] = {"grads": None}

    def grad_buffer(params):
        g = held["grads"]
        if g is not None and all(
                a.shape == b.shape and a.dtype == b.dtype
                and a.device == b.device and type(a) is type(b)
                and getattr(a, "placements", None)
                == getattr(b, "placements", None)
                for a, b in zip(leaves(g), leaves(params))):
            for t in leaves(g):
                t.zero_()
            return g
        held["grads"] = None      # free the old buffer before the new one
        held["grads"] = map_tree(torch.zeros_like, params)
        return held["grads"]

    def loss_and_backward(tree, mb):
        loss, metrics = model.loss_fn(tree, cfg, mb)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch, rng=None):
        del rng  # data pipeline owns randomness; kept in signature for parity
        m = tc.num_microbatches
        grads = grad_buffer(params)
        tree = attach_grads(cfg, params, grads)
        if m <= 1:
            loss, metrics = loss_and_backward(tree, batch)
        else:
            mbs = _microbatch(batch, m)
            loss_sum = 0.0
            for i in range(m):
                loss_i, _ = loss_and_backward(
                    tree, {k: _rows(v[i]) for k, v in mbs.items()})
                loss_sum = loss_sum + loss_i
            for g in leaves(grads):
                g.div_(m)
            loss = loss_sum / m
            metrics = {"ce": loss,
                       "moe_aux": torch.zeros((), dtype=torch.float32,
                                              device=loss.device)}
        del tree

        if tc.grad_compression == "int8_ef":
            grads, opt_state = compression.apply_int8_ef(grads, opt_state)

        params, opt_state, opt_metrics = optim.adamw_update(
            params, grads, opt_state, tc)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, _global(metrics)

    return train_step


def _global(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric as a plain tensor of its global value: on a mesh a loss
    is a DTensor whose sum over the data ranks may still be pending
    (``Partial``), and ``float()`` of it would read one rank's part."""
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in metrics.items()}


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss_fn(params, cfg, batch)
        return _global({"loss": loss, **metrics})
    return eval_step
