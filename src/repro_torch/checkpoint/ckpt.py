"""Checkpointing: async, atomic, keep-K.

A copy of ``repro.checkpoint.ckpt`` in PyTorch, in the same layout: one
directory per step (``step_000123/``) holding an ``arrays.npz``
(path-keyed leaves, the paths written as ``jax.tree_util.keystr`` writes
them) + ``meta.json``, published atomically via tmp-dir rename — a reader
can never observe a torn checkpoint, and a crash mid-write leaves the
previous checkpoint intact (the property restart correctness depends on).

Leaves are copied to the host when ``save`` is called (the training step
updates its tensors in place afterwards); a DTensor leaf is saved whole
(every rank calls ``save``, rank 0 writes). In a process group ``wait``
and ``restore`` are collective: every rank passes a barrier once rank 0's
write is published, so every rank reads the same latest step.
Restore places each leaf on its template leaf's device; with
``shardings=`` (a tree of ``NamedSharding``s, or ``None`` leaves, of the
template's structure) each leaf becomes a DTensor laid out by its
sharding, and each rank keeps only its block of the saved array: a
checkpoint written on one mesh restores onto a mesh of another shape.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import place
from repro_torch.train.tree import flatten_with_path, map_with_path

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _to_numpy(leaf: torch.Tensor, keep: bool = True) -> Optional[np.ndarray]:
    """A host copy of the leaf: the training step updates its tensors in
    place, so a snapshot must not share their memory (``.numpy()`` of a CPU
    tensor would). A DTensor is gathered whole, a collective every rank
    takes part in; a rank that does not write (``keep=False``) makes no
    host copy."""
    t = leaf.detach()
    if hasattr(t, "full_tensor"):               # a DTensor: the whole array
        t = t.full_tensor()
    if not keep:
        return None
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


def _flatten(tree, keep: bool = True) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf, keep)
            for path, leaf in flatten_with_path(tree)}


def _unflatten(template, arrays: Dict[str, np.ndarray], shardings=None):
    def load(key, tmpl, sh=None):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = torch.from_numpy(np.array(arrays[key]))
        if sh is None:
            return arr.to(tmpl.device)
        return place(arr, sh, device=tmpl.device)
    if shardings is None:
        return map_with_path(load, template)
    return map_with_path(load, template, shardings)


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _writes() -> bool:
    """Rank 0 of a process group writes (every rank calls ``save``: a
    DTensor leaf is gathered whole, a collective); alone, the process."""
    import torch.distributed as dist
    return not _in_group() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._inflight: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- write path ----

    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             blocking: Optional[bool] = None):
        """Snapshot `tree` at `step`. Device tensors are fetched
        synchronously (consistency), file I/O happens on a worker thread
        (overlap with the next training steps) unless blocking. In a
        process group every rank calls it and rank 0 writes; call
        ``wait`` on every rank before another rank reads the step."""
        writes = _writes()
        arrays = _flatten(tree, keep=writes)
        if not writes:
            return
        meta = dict(meta or {}, step=step, time=time.time())
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if blocking is None:
            blocking = not self.async_save
        if blocking:
            self._write(step, arrays, meta)
        else:
            t = threading.Thread(target=self._write, args=(step, arrays, meta),
                                 daemon=True)
            t.start()
            self._inflight = t

    def _write(self, step: int, arrays, meta):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, f".tmp_{name}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        final = os.path.join(self.dir, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
        self._gc()

    def wait(self):
        """Until the last ``save`` is published; in a process group a
        collective: every rank returns once rank 0's write is published."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if _in_group():
            import torch.distributed as dist
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---- read path ----

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest published step; in a process group, read it after
        :meth:`wait` so that every rank sees the same one."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings=None) -> Tuple[Any, dict]:
        """The tree saved at ``step`` (the latest by default). In a process
        group a collective: it first waits for the last ``save``
        (:meth:`wait`), so every rank reads the same step."""
        if _in_group():
            self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return _unflatten(template, arrays, shardings), meta
