"""Checkpointing: async, atomic, keep-K.

A copy of ``repro.checkpoint.ckpt`` in PyTorch, in the same layout: one
directory per step (``step_000123/``) holding an ``arrays.npz``
(path-keyed leaves, the paths written as ``jax.tree_util.keystr`` writes
them) + ``meta.json``, published atomically via tmp-dir rename — a reader
can never observe a torn checkpoint, and a crash mid-write leaves the
previous checkpoint intact (the property restart correctness depends on).

Leaves are copied to the host when ``save`` is called (the training step
updates its tensors in place afterwards); restore places each leaf on its
template leaf's device. Restoring onto a mesh (``shardings=``) waits
for the ``distributed/`` slice of the port.
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

from repro_torch.train.tree import flatten_with_path, map_with_path

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of the leaf: the training step updates its tensors in
    place, so a snapshot must not share their memory (``.numpy()`` of a CPU
    tensor would)."""
    t = leaf.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in flatten_with_path(tree)}


def _unflatten(template, arrays: Dict[str, np.ndarray], shardings=None):
    if shardings is not None:
        raise NotImplementedError(
            "restoring with shardings waits for the distributed/ slice of "
            "the port (ROADMAP Queue 1)")

    def place(key, tmpl):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        return torch.from_numpy(np.array(arrays[key])).to(tmpl.device)
    return map_with_path(place, template)


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
        (overlap with the next training steps) unless blocking."""
        arrays = _flatten(tree)
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
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

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
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings=None) -> Tuple[Any, dict]:
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
