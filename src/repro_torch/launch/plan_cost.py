"""The dry-run's counter: per-device flops, bytes, collectives and peak
memory of a step, counted op by op as it runs.

The counterpart of the reference's ``_cost_dict``, ``parse_collectives``,
``_bytes_of_sig`` and ``compiled.memory_analysis()``
(``repro/launch/dryrun.py``). Where the reference reads XLA's per-device
HLO, :class:`PlanCounter` is a dispatch mode that sees the ops each rank
runs:

* Under DTensor it returns ``NotImplemented`` for an op on DTensors, so
  DTensor runs it and the mode sees the ops on each rank's local blocks
  (and the functional collectives of every redistribution), at local
  shapes. Ops dispatched from inside DTensor's sharding propagator are its
  shape inference on global fake tensors, not work: they are skipped.
* **Flops** are ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention, and the formulas kernels F and G register) on
  the local shapes: what ``FlopCounterMode`` counts on one rank. Those of
  f32 operands are kept apart (``flops_f32``): the card runs them outside
  its tensor cores.
* **Bytes accessed**: each op that is not a view reads its tensor inputs
  and writes its outputs once (an expanded input counts its storage), as
  an eager op does in device memory.
* **Collectives** by the reference's kinds, each with its count and the
  local bytes of its output.
* **Memory**: the bytes of every live storage, arguments included
  (:meth:`PlanCounter.hold`), and their peak. A storage counts from the
  op that creates it until it is freed.

The ctypes kernels A-E take data pointers and no torch op, so the mode
does not see them (as XLA's cost model does not see a Pallas custom
call); ``core.fleet.lower_fleet`` lists their launches by name.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the functional collectives by the reference's collective kinds
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_F32 = (torch.float32, torch.float64)
_SHAPE_INFERENCE = "_sharding_prop.py"     # DTensor's sharding propagator
_INDEX_ARITHMETIC = "placement_types.py"   # its placements' offsets
_DTENSOR_FILES = "/torch/distributed/tensor/"


@dataclasses.dataclass
class MemoryAnalysis:
    """Per-device bytes of a planned step, under the names of XLA's
    ``memory_analysis()``: the arguments' storages, the outputs'
    (``alias_size_in_bytes`` of them are argument storages, updated in
    place), and the temporaries at the peak (the peak of all live bytes
    less the arguments and the new outputs)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int

    @property
    def peak_bytes(self) -> int:
        return (self.argument_size_in_bytes + self.output_size_in_bytes
                + self.temp_size_in_bytes - self.alias_size_in_bytes)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree (dicts, lists, tuples, NamedTuples; a DTensor
    as its local block). (A loop, not a recursive closure: a closure that
    calls itself is a reference cycle, which would keep an op's tensors
    alive until the garbage collector runs.)"""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x.to_local() if hasattr(x, "to_local") else x)
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
    return out


def _storage_key(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(t.untyped_storage())


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op touches in ``t``: its elements, at most its
    storage (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _dtensor_caller() -> Tuple[Optional[str], bool]:
    """(the file of the nearest DTensor frame or None, whether DTensor's
    sharding propagator is on the stack) for the op being dispatched."""
    f = sys._getframe(2)
    nearest = None
    while f is not None:
        name = f.f_code.co_filename
        if nearest is None and _DTENSOR_FILES in name:
            nearest = name
        if name.endswith(_SHAPE_INFERENCE):
            return nearest, True
        f = f.f_back
    return nearest, False


def _index_arithmetic(nearest: Optional[str], args, kwargs) -> bool:
    """Whether an op is DTensor's own index arithmetic for a placement's
    offsets: called from its placements, on no tensor of the step (no fake
    input). It reads values back (``tolist``), so it runs on real tensors
    even under a fake mode, and is no work of the step."""
    if nearest is None or not nearest.endswith(_INDEX_ARITHMETIC):
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    return not any(isinstance(t, FakeTensor)
                   for t in _tensors((args, kwargs)))


class PlanCounter(TorchDispatchMode):
    """Counts what one rank runs while it is active (see the module's
    docstring). ``trace=True`` keeps one line per counted op
    (:attr:`trace`)."""

    def __init__(self, trace: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0
        self.flops_f32 = 0
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.trace: Optional[List[str]] = [] if trace else None
        self._live: Dict[Any, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._args: Dict[Any, int] = {}

    # ---- memory ---------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._live:
            return
        n = t.untyped_storage().nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t.untyped_storage(), self._free, key)

    def _free(self, key) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self.live_bytes -= n

    def hold(self, tree) -> None:
        """Count the storages of ``tree`` (a step's arguments) as live and
        as arguments, and start the peak from here."""
        for t in _tensors(tree):
            self._track(t)
            key = _storage_key(t)
            self._args[key] = self._live[key]
        self.peak_bytes = self.live_bytes

    def memory_analysis(self, outputs) -> MemoryAnalysis:
        """The bytes of the arguments held, of ``outputs`` and of the
        temporaries at the peak."""
        arg = sum(self._args.values())
        seen = {}
        for t in _tensors(outputs):
            seen[_storage_key(t)] = t.untyped_storage().nbytes()
        out = sum(seen.values())
        alias = sum(n for k, n in seen.items() if k in self._args)
        return MemoryAnalysis(
            argument_size_in_bytes=arg, output_size_in_bytes=out,
            temp_size_in_bytes=max(self.peak_bytes - arg - (out - alias), 0),
            alias_size_in_bytes=alias)

    # ---- costs ----------------------------------------------------------

    def cost(self) -> Dict[str, Any]:
        """{"flops", "flops_f32", "bytes", "collectives"}: the probe
        record of the reference's ``_analyze`` (``flops_f32`` added)."""
        return {"flops": float(self.flops), "flops_f32": float(self.flops_f32),
                "bytes": float(self.bytes),
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()}}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented          # DTensor runs it on local blocks
        ns = func.namespace
        if ns == "prim":
            return func(*args, **kwargs)
        nearest, shape_inference = _dtensor_caller()
        if _index_arithmetic(nearest, args, kwargs):
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        if shape_inference:                # global fake tensors: no work
            return func(*args, **kwargs)
        with self:                         # as FlopCounterMode does
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func._overloadpacket.__name__
        if ns == "_c10d_functional":
            if name != "wait_tensor":
                self._collective(name, outs)
            return out
        in_keys = {_storage_key(t) for t in ins}
        new = [t for t in outs if _storage_key(t) not in in_keys]
        if func.is_view or not (new or func._schema.is_mutable):
            return out                     # a view: no work, no storage
        for t in new:
            self._track(t)
        packet = func._overloadpacket
        fl = 0
        if packet in self._registry:
            fl = int(self._registry[packet](*args, **kwargs, out_val=out))
            self.flops += fl
            if ins and ins[0].dtype in _F32:
                self.flops_f32 += fl
        nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += nb
        if self.trace is not None:
            self.trace.append(
                f"{func} in={[tuple(t.shape) for t in ins]} "
                f"out={[tuple(t.shape) for t in outs]} flops={fl} bytes={nb}")
        return out

    def _collective(self, name: str, outs) -> None:
        kind = COLLECTIVE_KINDS.get(name)
        if kind is None:
            raise ValueError(f"the plan has no kind for collective {name!r}")
        for t in outs:
            self._track(t)
        s = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += sum(t.numel() * t.element_size() for t in outs)
        if self.trace is not None:
            self.trace.append(f"{kind} {name} "
                              f"out={[tuple(t.shape) for t in outs]}")
