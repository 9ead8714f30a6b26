"""Parameter trees as the reference's pytrees: nested dicts (keys in sorted
order, as ``jax.tree`` flattens them), lists and tuples (in order),
NamedTuples (fields in order; a ``None`` field holds no leaf) and tensors
or arrays at the leaves. Paths are written as ``jax.tree_util.keystr``
writes them, so checkpoints carry across between the two packages."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_with_path(getattr(tree, f),
                                            f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in flatten_with_path(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[map_tree(fn, getattr(tree, f),
                                     *[getattr(r, f) for r in rest])
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, t, *[r[i] for r in rest])
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over ``tree`` and trees of its
    structure, paths as :func:`flatten_with_path` writes them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *[r[k] for r in rest],
                                 prefix=f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[map_with_path(fn, getattr(tree, f),
                                          *[getattr(r, f) for r in rest],
                                          prefix=f"{prefix}.{f}")
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, t, *[r[i] for r in rest],
                                        prefix=f"{prefix}[{i}]")
                          for i, t in enumerate(tree))
    return fn(prefix, tree, *rest)
