"""Logical-axis sharding over a ``torch.distributed`` ``DeviceMesh``.

A copy of ``repro.distributed.sharding`` in PyTorch. Model code annotates
parameters and activations with *logical* axis names ("embed", "ff",
"batch", ...). A rule set maps logical names to mesh axes. Rules differ
between training (FSDP over data+pod, TP over model) and serving (TP over
model, weight-gather over data), and adapt per architecture (e.g.
expert-parallel only when n_experts divides the TP degree).

Where the reference lets XLA's partitioner place arrays from
``NamedSharding``s, the port uses DTensor: a :class:`NamedSharding` turns
its spec into DTensor placements, :func:`logical_constraint` redistributes
a DTensor (or distributes a plain tensor) to them, and ``local_map``
stands in for ``shard_map`` (:func:`import_shard_map`).

Everything degrades to a no-op when no mesh/rules are active, so the same
model code runs single-device unchanged. While a mesh is active
(:func:`axis_rules`), DTensor treats a plain tensor that meets a DTensor
in an op as replicated (``implicit_replication``): the positions, masks
and zeros that the model code makes are the same on every rank.

:func:`make_rules`, :func:`resolve_spec` and :func:`mesh_axis_size` only
read a mesh's axis names and sizes, so they take a ``DeviceMesh`` or any
object with ``axis_names`` and ``devices.shape`` (as the reference's tests
fake a 16x16 mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

try:          # a build without torch.distributed has no DTensor to meet
    from torch.distributed.tensor import DTensor as _DTensor
except ImportError:
    _DTensor = None

Axis = Union[str, None, Tuple[str, ...]]

_state = threading.local()


class P(tuple):
    """The port's ``PartitionSpec``: one entry per tensor dim, each
    ``None``, a mesh-axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def import_shard_map():
    """``(local_map, kwargs)``: the counterpart of the reference's
    ``shard_map`` shim. Every explicit-collective site goes through it; the
    inputs are redistributed to the placements the region asks for."""
    from torch.distributed.tensor.experimental import local_map
    return local_map, {"redistribute_inputs": True}


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a duck-typed mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def dtensor_mesh(mesh):
    """The mesh the DTensors of ``mesh`` live on: its axes of size > 1 (its
    last axis where every axis has size 1). An axis of size 1 holds every
    block whole, so it drops out of the layout, and DTensor's planner does
    not search over it."""
    # kept on the mesh itself (a mesh of a later world of the same shape
    # compares equal to an ended one, so no dict keyed by mesh would do)
    sub = getattr(mesh, "_dtensor_submesh", None)
    if sub is None:
        sizes = axis_sizes(mesh)
        keep = tuple(n for n, s in sizes.items() if s > 1) or \
            (tuple(sizes)[-1],)
        sub = mesh if keep == tuple(sizes) else mesh[keep]
        mesh._dtensor_submesh = sub
    return sub


def _current() -> Tuple[Optional[Any], Optional[Dict[str, Axis]]]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication`` (a per-thread flag, which its
    context manager clears on exit) entered by the outermost of nested
    activations in this thread."""
    from torch.distributed.tensor.experimental import implicit_replication
    depth = getattr(_state, "replicating", 0)
    _state.replicating = depth + 1
    try:
        if depth:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _state.replicating = depth


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, Axis]]):
    """Activate (mesh, rules) for logical_constraint / make_sharding calls,
    in this thread. With a mesh, DTensor's implicit replication is on for
    the duration."""
    old = _current()
    _state.mesh, _state.rules = mesh, rules
    try:
        if mesh is None:
            yield
        else:
            with _implicit_replication():
                yield
    finally:
        _state.mesh, _state.rules = old


def under_current_rules(fn):
    """``fn`` run under the (mesh, rules) active now, whichever thread
    calls it later (a checkpointed block recomputed in the backward)."""
    mesh, rules = _current()
    if mesh is None:
        return fn

    def run(*args):
        with axis_rules(mesh, rules):
            return fn(*args)
    return run


def resolve_spec(axes: Sequence[Optional[str]],
                 rules: Dict[str, Axis]) -> P:
    """Map logical axis names -> PartitionSpec, dropping duplicate mesh axes.

    A mesh axis may appear at most once in a PartitionSpec; when two logical
    dims resolve to the same mesh axis, the later one is left unsharded.
    """
    used = set()
    out = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(a for a in ms if a not in used)
        if not ms:
            out.append(None)
        else:
            used.update(ms)
            out.append(ms if len(ms) > 1 else ms[0])
    return P(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh. :attr:`placements` are its DTensor placements, one
    per mesh dim: ``Shard(d)`` where tensor dim d names the mesh dim, else
    ``Replicate()``. A dim over several mesh axes (``("pod", "data")``) is
    ``Shard(d)`` on each, major to minor in mesh order, the reference's
    block order. The placements are over :attr:`device_mesh`, the mesh's
    axes of size > 1 (:func:`dtensor_mesh`)."""

    mesh: Any
    spec: P

    @property
    def device_mesh(self):
        return dtensor_mesh(self.mesh)

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(self.mesh)
        kept = self.device_mesh.mesh_dim_names
        out = [Replicate() for _ in kept]
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            ms = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [names.index(a) for a in ms]
            if idx != sorted(idx):
                raise ValueError(f"{self.spec}: a dim's axes {ms} must be in "
                                 f"mesh order {names}")
            for a in ms:
                if a in kept and axis_sizes(self.mesh)[a] > 1:
                    out[kept.index(a)] = Shard(d)
        return tuple(out)

    def local_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` (a view; torch.chunk
        sizes, as DTensor's ``Shard``)."""
        pls = self.placements
        for d in range(x.dim()):
            lo, n = block_range(self.device_mesh, pls, d, x.shape[d])
            if n != x.shape[d]:
                x = x.narrow(d, lo, n)
        return x


def is_dtensor(x) -> bool:
    return _DTensor is not None and isinstance(x, _DTensor)


def place(x: torch.Tensor, sharding: NamedSharding, device=None):
    """``x`` (the global value, the same on every rank) as a DTensor laid
    out by ``sharding``; a DTensor is redistributed. Where every placement
    is ``Replicate`` (always on a world of 1) the DTensor wraps ``x``
    itself, with no copy; else this rank keeps its block, made contiguous.
    ``device`` moves the block there (a host array onto the card)."""
    from torch.distributed.tensor import DTensor, Replicate
    pls = sharding.placements
    dmesh = sharding.device_mesh
    if isinstance(x, DTensor):
        if tuple(x.placements) == pls:
            return x
        return x.redistribute(dmesh, pls)
    if all(isinstance(p, Replicate) for p in pls):
        x = x if device is None else x.to(device)
        return DTensor.from_local(x, dmesh, pls, run_check=False)
    local = sharding.local_block(x).contiguous()
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local, dmesh, pls, run_check=False,
                              shape=x.shape, stride=contiguous_stride(x.shape))


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor's global
    strides, which ``from_local`` needs where blocks are uneven)."""
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= size
    return tuple(stride)


class _Constrain(torch.autograd.Function):
    """A DTensor laid out by a sharding, whose gradient is laid out by the
    same sharding: the reference's ``with_sharding_constraint``, whose
    transpose constrains the cotangent alike. (DTensor's own redistribute
    hands the gradient back in the input's layout, so a backward would
    follow whatever layout the forward's input had.)"""

    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding = sharding
        out = place(x, sharding)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return place(grad, ctx.sharding), None


def logical_constraint(x, *axes: Optional[str]):
    """The layout of ``x`` by logical axes (and, for a DTensor that needs
    a gradient, the layout of its gradient); no-op without an active
    mesh."""
    mesh, rules = _current()
    if mesh is None or rules is None:
        return x
    sh = NamedSharding(mesh, resolve_spec(axes, rules))
    if is_dtensor(x) and x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, sh)
    return place(x, sh)


def make_sharding(axes: Sequence[Optional[str]], mesh,
                  rules: Dict[str, Axis]) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(axes, rules))


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def make_rules(mesh, mode: str, cfg=None) -> Dict[str, Axis]:
    """Build the logical->mesh rule set.

    mode='train': batch + FSDP over (pod?, data); TP over model.
    mode='prefill': train layout + serve-style KV-cache sharding (the cache
                    is the prefill OUTPUT and must fit like decode's input).
    mode='serve': batch over (pod?, data); weights TP over model and
                  secondary-sharded over data (gathered per layer).
    mode='serve_seq': B too small to shard -> KV-cache sequence over data.
    """
    has_pod = "pod" in axis_names(mesh)
    dp: Axis = ("pod", "data") if has_pod else ("data",)
    tp = "model"
    tp_deg = mesh_axis_size(mesh, "model")

    rules: Dict[str, Axis] = {
        # activations
        "batch": dp,
        "seq": None,
        "act_embed": None,
        "act_ff": tp,
        "act_q": tp,
        "act_kv": None,
        "tokens": dp,          # flattened token dim in MoE dispatch
        "seq_kv": None,
        # params
        "embed": dp,           # FSDP dim
        "vocab": tp,
        "q_dim": tp,
        "kv_dim": tp,
        "ff": tp,
        "ssm_proj": tp,
        "ssm_inner": tp,
        "conv_ch": tp,
        "ssm_heads": tp,
        "ssm_state": None,
        "head_dim": None,
        "heads": None,         # set below if divisible
        "expert": None,        # set below
        "expert_ff": None,
        "codebook": None,
        "stack": None,         # the stacked-repeats leading dim
    }

    if cfg is not None:
        if _divides(getattr(cfg, "n_heads", 0), tp_deg) or \
                getattr(cfg, "pad_head_shard", False):
            rules["heads"] = tp
        if _divides(getattr(cfg, "ssm_heads", 0), tp_deg):
            rules["act_ssm_heads"] = tp
        else:
            rules["act_ssm_heads"] = None
        n_exp = getattr(cfg, "n_experts", 0)
        if _divides(n_exp, tp_deg):
            rules["expert"] = tp           # expert parallelism
            rules["expert_ff"] = None
        elif n_exp:
            rules["expert"] = None         # per-expert tensor parallelism
            rules["expert_ff"] = tp

    if mode == "prefill":
        if cfg is not None and _divides(getattr(cfg, "n_kv_heads", 0), tp_deg):
            rules["act_kv"] = tp
        else:
            rules["seq_kv"] = (tp,)
    elif mode == "serve":
        rules["embed"] = dp                # weights stay data-sharded
        # KV caches are the serving memory bill: batch shards over data, and
        # the cache shards over the TP axis too — by kv-HEADS when the count
        # divides it (MHA archs; keeps the cache update local), else by
        # SEQUENCE (GQA's 4-8 kv heads can't shard 16 ways).
        if cfg is not None and _divides(getattr(cfg, "n_kv_heads", 0), tp_deg):
            rules["act_kv"] = tp
        else:
            rules["seq_kv"] = (tp,)
    elif mode == "serve_seq":
        rules["embed"] = dp
        rules["batch"] = None
        rules["tokens"] = None
        rules["seq_kv"] = ("data", tp)     # B=1: sequence is the only big dim
    elif mode != "train":
        raise ValueError(f"unknown sharding mode {mode!r}")
    return rules


def block_range(dmesh, placements, dim: int, size: int) -> Tuple[int, int]:
    """(start, length) of this rank's block along tensor dim ``dim`` (of
    global ``size``) under ``placements`` on the DTensor mesh ``dmesh``:
    nested torch.chunk blocks, major mesh dim first, as DTensor's
    ``Shard`` cuts them."""
    from torch.distributed.tensor import Shard
    lo, cur = 0, size
    coord = dmesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            step = -(-cur // dmesh.size(i))
            off = min(coord[i] * step, cur)
            lo, cur = lo + off, min(step, cur - off)
    return lo, cur


def zeros(shape, axes: Sequence[Optional[str]], dtype, device):
    """``torch.zeros(shape)`` on ``device``; under an active mesh a DTensor
    laid out by ``axes`` on the mesh's device, each rank allocating only
    its block."""
    mesh, rules = _current()
    if mesh is None or rules is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as dzeros
    sh = make_sharding(axes, mesh, rules)
    return dzeros(tuple(shape), dtype=dtype, device_mesh=sh.device_mesh,
                  placements=sh.placements)


def on_whole(fn, *args, n_out: int = 1):
    """``fn(*args)`` on whole tensors. Where an argument is a DTensor, each
    DTensor argument is replicated and ``fn`` runs on every rank's (whole)
    local copy inside ``local_map``; its ``n_out`` outputs are replicated
    DTensors. For index operators that DTensor has no sharding strategy
    for in some torch releases (``index_add_`` in 2.11), or that would
    apply global indices to a split operand's local block: the same
    arithmetic as without a mesh, on every rank."""
    dt = next((a for a in args if is_dtensor(a)), None)
    if dt is None:
        return fn(*args)
    from torch.distributed.tensor import Replicate
    rep = tuple(Replicate() for _ in dt.placements)
    local_map, kw = import_shard_map()
    return local_map(
        fn, out_placements=list(rep) if n_out == 1 else (rep,) * n_out,
        in_placements=tuple(rep if is_dtensor(a) else None for a in args),
        device_mesh=dt.device_mesh, **kw)(*args)


def write_slice(dst, dim: int, start: int, src) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim``, in place. A
    DTensor ``dst`` is written inside ``local_map``: DTensor has no
    in-place strategy for a slice of a sharded dim (its slice would be a
    copy, and the write would land there), so each rank writes the part of
    ``src`` that falls in its own block."""
    if not is_dtensor(dst):
        idx = (slice(None),) * dim + (slice(start, start + src.shape[dim]),)
        dst[idx] = src
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pls = dst.device_mesh, tuple(dst.placements)
    src_pls = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                    else p for p in pls)
    if not is_dtensor(src):                  # the global value, replicated
        src = DTensor.from_local(src, mesh, tuple(Replicate() for _ in pls),
                                 run_check=False)
    lo, n = block_range(mesh, pls, dim, dst.shape[dim])
    a, b = max(start, lo), min(start + src.shape[dim], lo + n)

    def local_write(d, s):
        if a < b:
            idx = (slice(None),) * dim + (slice(a - lo, b - lo),)
            d[idx] = s.narrow(dim, a - start, b - a)

    local_map, kw = import_shard_map()
    local_map(local_write, out_placements=None, in_placements=(pls, src_pls),
              device_mesh=mesh, **kw)(dst, src)


def split_dim(x, dim: int, shape):
    """``x.reshape(shape)``, where ``shape`` splits x's dim ``dim`` in two
    (into ``shape[dim]`` and ``shape[dim + 1]``). DTensor cannot view a dim
    split over n ranks as (a, b) unless n divides a; the dim is replicated
    first where it does not."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        n = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == dim:
                n *= x.device_mesh.size(i)
        if shape[dim] % n:
            x = gather_dim(x, dim)
    return x.reshape(shape)


def gather_dim(x, dim: int):
    """The DTensor ``x`` with its dim ``dim`` whole on every rank (each
    ``Shard`` of it made ``Replicate``); the other placements kept."""
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.dim()
    pls = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in x.placements)
    return x if pls == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pls)
