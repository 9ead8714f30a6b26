"""Sharding trees: map logical-axis trees to :class:`NamedSharding` trees
for parameters, optimizer state, batches and serving caches, and place a
tree by them.

A copy of ``repro.distributed.placement`` in PyTorch; :func:`place_tree`
is the counterpart of ``jax.device_put`` on a tree.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (NamedSharding, P, axis_sizes,
                                              make_sharding, place)
from repro_torch.models import model
from repro_torch.train import optim
from repro_torch.train.tree import map_tree


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and (
        len(x) == 0 or isinstance(x[0], (str, type(None))))


def _map_axes(fn, tree):
    if _is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return type(tree)(_map_axes(fn, v) for v in tree)


def tree_shardings(axes_tree, mesh, rules) -> Any:
    return _map_axes(lambda ax: make_sharding(ax, mesh, rules), axes_tree)


def param_shardings(cfg: ModelConfig, mesh, rules) -> Any:
    return tree_shardings(model.param_logical_axes(cfg), mesh, rules)


def opt_shardings(param_sh, mesh, with_ef: bool = False):
    scalar = NamedSharding(mesh, P())
    ef = map_tree(lambda s: s, param_sh) if with_ef else None
    return optim.OptState(step=scalar, mu=param_sh, nu=param_sh, ef=ef)


def batch_shardings(cfg: ModelConfig, mesh, rules
                    ) -> Dict[str, NamedSharding]:
    tok = make_sharding(("batch", "seq") + (("codebook",)
                                            if cfg.n_codebooks > 1 else ()),
                        mesh, rules)
    out = {"tokens": tok, "labels": tok}
    if cfg.n_prefix:
        out["vision_embeds"] = make_sharding(("batch", "seq", "act_embed"),
                                             mesh, rules)
    return out


def cache_shardings(cfg: ModelConfig, mesh, rules) -> Any:
    return tree_shardings(model.cache_logical_axes(cfg), mesh, rules)


def choose_serve_mode(shape: ShapeConfig, mesh) -> str:
    """B=1 long-context decode can't shard the batch: shard the KV-cache
    sequence dim over 'data' instead."""
    dp = 1
    sizes = axis_sizes(mesh)
    for ax in ("pod", "data"):
        dp *= sizes.get(ax, 1)
    return "serve" if shape.global_batch % dp == 0 else "serve_seq"


def place_tree(tree, shardings):
    """Each leaf of ``tree`` (the global value, the same on every rank) as
    a DTensor laid out by its sharding in ``shardings`` (the same
    structure; a ``None`` sharding leaves the leaf as it is). A leaf whose
    placements are all ``Replicate`` (every leaf on a world of 1) is
    wrapped without a copy."""
    return map_tree(lambda t, sh: t if sh is None else place(t, sh),
                    tree, shardings)
