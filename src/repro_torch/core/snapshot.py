"""Pause / snapshot / restore (paper §IV: AGOCS can pause and snapshot task
distributions; restoring "is not implemented yet" — here it is).

A snapshot is the SimState + config + progress counters in the reference's
npz layout (``state/<field>`` arrays, a JSON ``__meta__``), so a snapshot
written by either package loads in the other. State leaves the device with
``.cpu().numpy()`` — 0-d counters stay 0-d — and comes back onto the
caller's device. Restoring yields a bit-identical state: resumed
simulations produce identical stats (tested, single-trajectory AND
lane-batched fleet states).

Loading is *config-drift tolerant*: a snapshot written under an older or
newer SimConfig schema still loads — unknown keys are filtered out (and
surfaced in ``Snapshot.extra["dropped_cfg_keys"]``), missing keys take the
current dataclass defaults. The caller-supplied ``extra`` metadata dict is
returned as written (it used to be silently dropped).

**Checksum-on-save / verify-on-restore.** ``save_snapshot`` records a crc32
per state field in the meta; ``load_snapshot`` verifies them (on by
default — the arrays are already in memory, so the check is one cheap pass)
and raises :class:`SnapshotCorruptionError` *naming the corrupt field*. The
write itself goes through a uniquely-named temp file, fsync, then an atomic
rename — a crash mid-save can never leave a torn snapshot at the target
path, matching the pre-compiled-stack contract in ``core.precompile``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zipfile
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config import SimConfig
from repro_torch.core.state import SimState
from repro_torch.device import resolve_device
from repro_torch.resilience.faults import maybe_fault


class SnapshotCorruptionError(ValueError):
    """A snapshot failed its crc32 verification — the message names the
    corrupt state field."""


class Snapshot(NamedTuple):
    """What ``load_snapshot`` returns — unpacks as (state, cfg, done, extra)."""
    state: SimState
    cfg: SimConfig
    windows_done: int
    extra: dict


def save_snapshot(path: str, state: SimState, cfg: SimConfig,
                  windows_done: int = 0, extra: Optional[dict] = None):
    out_dir = os.path.dirname(path) or "."
    os.makedirs(out_dir, exist_ok=True)
    # np.asarray, NOT ascontiguousarray: the latter promotes 0-d scalar
    # counters to shape (1,), breaking bitwise state equality after restore.
    arrays = {f"state/{f}": np.asarray(getattr(state, f).cpu().numpy())
              for f in SimState._fields}
    crc = {f: zlib.crc32(arrays[f"state/{f}"].tobytes())
           for f in SimState._fields}
    meta = {"cfg": dataclasses.asdict(cfg), "windows_done": windows_done,
            "extra": extra or {}, "crc": crc}
    fd, tmp = tempfile.mkstemp(dir=out_dir,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)                  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def config_from_meta(cfg_meta: dict) -> "tuple[SimConfig, list]":
    """A SimConfig from persisted metadata, tolerating schema drift.

    Keys the current SimConfig doesn't know are dropped (and returned);
    keys the snapshot predates fall back to the dataclass defaults.
    """
    known = {f.name for f in dataclasses.fields(SimConfig)}
    dropped = sorted(set(cfg_meta) - known)
    cfg = SimConfig(**{k: v for k, v in cfg_meta.items() if k in known})
    return cfg, dropped


def load_snapshot(path: str, verify: bool = True,
                  device=None) -> Snapshot:
    """Load (and by default crc-verify) a snapshot, its state on ``device``
    (the card unless "cpu" is passed). Snapshots written before checksums
    existed load unverified — same drift tolerance as the config.
    """
    maybe_fault("snapshot_restore")            # chaos: failed/slow restores
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            host = {f: np.asarray(z[f"state/{f}"]) for f in SimState._fields}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError) as e:
        raise SnapshotCorruptionError(
            f"corrupt snapshot {path}: unreadable archive ({e})") from e
    crc = meta.get("crc")
    if verify and crc is not None:
        for f in SimState._fields:
            want = crc.get(f)
            if want is None:
                continue
            got = zlib.crc32(host[f].tobytes())
            if got != want:
                raise SnapshotCorruptionError(
                    f"corrupt snapshot {path}: state field {f!r} crc32 "
                    f"{got:#010x} != recorded {want:#010x} — the bytes "
                    f"changed since save_snapshot wrote them")
    dev = resolve_device(device)
    fields = {f: torch.from_numpy(np.array(host[f])).to(dev)
              for f in SimState._fields}
    cfg, dropped = config_from_meta(meta["cfg"])
    extra = dict(meta.get("extra") or {})
    if dropped:
        extra["dropped_cfg_keys"] = dropped
    return Snapshot(SimState(**fields), cfg, int(meta["windows_done"]), extra)
