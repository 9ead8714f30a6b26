"""§V-A alternative design, implemented: pre-process the trace once into
persisted event tensors, then replay without any parsing overhead.

``precompile_trace`` runs a trace-family parser once and serialises the
packed EventWindow stack to an npz; ``replay_windows`` streams it back.
This is the reference's module with its imports rewritten: a stack written
by either package replays in the other (and the same trace pre-compiles to
the same bytes in both).

The npz embeds the window-geometry metadata it was packed under (event
rows, reserved injection slot pool, resource/constraint column counts), so
consumers — most importantly ``ScenarioFleet.from_precompiled`` — can
refuse a stack whose shapes or slot-pool reservation don't match their
config instead of silently mis-simulating. Stacks written with
``cfg.inject_slots > 0`` are *slot-pool padded*: the last ``inject_slots``
rows of every window are PAD, ready for on-device event injection, so a
whole amplification sweep replays with zero parsing.

Stacks are written in **window chunks** (``shard_windows`` windows per zip
member) with a per-window row index and a per-member byte index embedded in
the meta, so a window *sub-range* — ``replay_windows(start_window=W)`` or
:func:`load_window_range` — decompresses only the chunks that overlap it
instead of materialising the whole trace: ``whatif --replay
--start-window`` and a fleet restored mid-trace start there. Legacy
single-member stacks (and ``shard_windows=0``) are still read, paying the
full-array decompression they always did.

**The writer streams.** ``precompile_trace`` consumes ``packed_windows``
as a generator, stacking and serialising one ``shard_windows``-sized chunk
at a time, so peak host memory is O(shard_windows) — a month-long
12.5K-node trace precompiles without ever residing in RAM. The emitted
archive is **bitwise identical** to the legacy materialise-then-savez
writer (kept behind ``streaming=False`` as the equivalence oracle and the
ingest-benchmark baseline): same member order (meta, then chunk-major data,
then the appended parse-stats + byte-index members), same npy headers, same
zlib stream. The flat legacy layout (``shard_windows=0``) streams too, by
spooling per-field raw bytes to temp files on disk (O(trace) disk, still
O(chunk) RAM) before wrapping them in npy members.

**Writes are crash-safe, reads are verifiable.** The writer lands in a
uniquely-named temp file and atomically renames after an fsync — an
interrupted precompile leaves nothing at the target path. Every data member
gets a crc32 (of its decompressed npy bytes) embedded in the meta;
:func:`verify_stack` / ``validate_replay(verify=True)`` /
``replay_windows(verify=True)`` check them and report corruption *by chunk
index* (truncated, bit-flipped and unreadable members alike), eagerly, on
the caller's thread.

The parser's anomaly counters (``ParseStats``) are persisted into the
stack's meta — at 12.5K-node scale a silent ``slot_overflow`` means dropped
tasks and corrupt results, so :func:`stack_parse_stats` lets any replay
consumer (and the CLIs) surface them long after the parse happened.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import zipfile
import zlib
from typing import Iterable, Iterator, List, Optional

import numpy as np
from numpy.lib import format as _npformat

from repro_torch.config import SimConfig
from repro_torch.core.events import EventWindow, empty_window, stack_windows
from repro_torch.resilience.faults import maybe_corrupt, maybe_fault


class StackCorruptionError(ValueError):
    """A pre-compiled stack failed an integrity check — the error message
    names the corrupt chunk/member so the operator knows exactly which bytes
    rotted instead of chasing a mis-simulation."""

# config fields that must match between the writer and the consumer for the
# tensor layout (and the injection slot-pool contract) to line up
_META_FIELDS = ("max_events_per_window", "inject_slots", "inject_task_slots",
                "max_tasks", "max_nodes", "n_resources", "n_usage_stats",
                "max_constraints", "window_us")

DEFAULT_SHARD_WINDOWS = 64

# ParseStats fields persisted into the stack meta (order is the archive
# contract; readers key by the names member, so appending is safe)
_PARSE_STAT_FIELDS = ("rows", "bad_rows", "usage_unknown_task",
                      "dup_terminal", "constraints_dead_task",
                      "slot_overflow", "attr_overflow")


def _chunk_key(c: int, name: str) -> str:
    return f"w/{c:05d}/{name}"


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray):
    """One npz member, exactly as ``np.savez_compressed`` writes it."""
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        _npformat.write_array(fid, np.asanyarray(arr), allow_pickle=False)


def _append_parse_stats(tmp: str, stats):
    """Persist the parser's anomaly counters into the stack meta.

    Appended after the data members (the counters are only final once the
    event stream is exhausted — which, for the streaming writer, is after
    the last chunk went out). ``stats`` is a ParseStats-shaped object.
    """
    names = np.asarray(_PARSE_STAT_FIELDS)
    vals = np.asarray([int(getattr(stats, f)) for f in _PARSE_STAT_FIELDS],
                      np.int64)
    with zipfile.ZipFile(tmp, "a", zipfile.ZIP_DEFLATED) as zf:
        _write_member(zf, "meta/parse_stats_names", names)
        _write_member(zf, "meta/parse_stats", vals)


def _append_member_crcs(tmp: str):
    """Embed a crc32 per data member (of its *decompressed* npy bytes).

    Appended after the data members, one member read back at a time (O(one
    member) host memory — the streaming writer's bound survives). The zip
    container has its own internal CRCs, but these are ours: readable via
    :func:`stack_member_crcs` without decompressing anything, and verified
    chunk-by-chunk by :func:`verify_stack` so a corrupt chunk is reported
    *by index* instead of surfacing as a generic zlib error mid-replay.
    """
    with zipfile.ZipFile(tmp) as zf:
        names = [i.filename for i in zf.infolist()
                 if i.filename.startswith("w/")]
        crcs = [zlib.crc32(zf.read(n)) for n in names]
    if not names:                              # empty stack: nothing to sum
        return
    keys = np.asarray([n[:-len(".npy")] for n in names])
    vals = np.asarray(crcs, np.int64)
    with zipfile.ZipFile(tmp, "a", zipfile.ZIP_DEFLATED) as zf:
        _write_member(zf, "meta/member_crc_names", keys)
        _write_member(zf, "meta/member_crc", vals)


def _append_byte_index(tmp: str):
    """Embed each data member's (header_offset, compressed_size) span.

    Appended as two extra members AFTER the archive's data members were
    closed, because offsets only exist once the members are written. The
    offsets point at the zip local-file headers, so an external reader can
    range-request exactly one chunk's bytes out of a remote stack.
    """
    with zipfile.ZipFile(tmp) as zf:
        infos = [(i.filename, i.header_offset, i.compress_size)
                 for i in zf.infolist() if i.filename.startswith("w/")]
    if not infos:                              # empty stack: nothing to index
        return
    names = np.asarray([n[:-len(".npy")] for n, _, _ in infos])
    spans = np.asarray([[off, sz] for _, off, sz in infos], np.int64)
    spans = spans.reshape(-1, 2)               # keep 2-D when empty
    with zipfile.ZipFile(tmp, "a", zipfile.ZIP_DEFLATED) as zf:
        for key, arr in (("meta/byte_index_names", names),
                         ("meta/byte_index", spans)):
            _write_member(zf, key, arr)


def _build_meta(cfg: SimConfig, W: int, shard_windows: int) -> dict:
    meta = {f"meta/{name}": np.asarray(getattr(cfg, name), np.int64)
            for name in _META_FIELDS}
    meta["meta/n_windows"] = np.asarray(W, np.int64)
    if shard_windows:
        starts = list(range(0, W, shard_windows)) + [W]
        meta["meta/window_index"] = np.asarray(starts, np.int64)
    return meta


def _chunked(stream: Iterable[EventWindow], size: int
             ) -> Iterator[List[EventWindow]]:
    buf: List[EventWindow] = []
    for w in stream:
        buf.append(w)
        if len(buf) == size:
            maybe_fault("precompile_write")    # chaos: die mid-archive
            yield buf
            buf = []
    if buf:
        maybe_fault("precompile_write")
        yield buf


def _write_stack_streaming(tmp: str, cfg: SimConfig,
                           stream: Iterable[EventWindow], W: int,
                           shard_windows: int):
    """Write the npz holding at most one shard_windows chunk in RAM.

    Member-for-member (and byte-for-byte) identical to
    ``np.savez_compressed(f, **meta, **data)`` over the materialised stack:
    meta members first (W is known up front — ``packed_windows`` pads to
    exactly ``n_windows``), then the chunk members in chunk-major, field-
    minor order, each serialised by the same ``format.write_array`` numpy's
    ``_savez`` uses.
    """
    meta = _build_meta(cfg, W, shard_windows)
    seen = 0
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zf:
        for key, arr in meta.items():
            _write_member(zf, key, arr)
        if shard_windows:
            for c, chunk in enumerate(_chunked(stream, shard_windows)):
                stacked = stack_windows(chunk)
                seen += len(chunk)
                if seen > W:
                    raise ValueError(f"stream produced more than the "
                                     f"declared {W} windows")
                for name in EventWindow._fields:
                    _write_member(zf, _chunk_key(c, name),
                                  getattr(stacked, name))
        else:
            seen = _write_flat_streaming(zf, cfg, stream, W)
    if seen != W:
        raise ValueError(f"stream produced {seen} windows, declared {W}")


def _write_flat_streaming(zf: zipfile.ZipFile, cfg: SimConfig,
                          stream: Iterable[EventWindow], W: int) -> int:
    """Stream the legacy flat layout (one member per field spanning all W
    windows). Zip members are sequential, so per-field bytes spool to temp
    files on disk first — O(trace) disk, still O(chunk) host memory."""
    spec = empty_window(cfg)                   # per-field dtype + tail shape
    spool_dir = tempfile.mkdtemp(prefix="agocs_flat_")
    try:
        paths = {name: os.path.join(spool_dir, name + ".bin")
                 for name in EventWindow._fields}
        files = {name: open(p, "wb") for name, p in paths.items()}
        seen = 0
        try:
            for chunk in _chunked(stream, DEFAULT_SHARD_WINDOWS):
                stacked = stack_windows(chunk)
                seen += len(chunk)
                if seen > W:
                    raise ValueError(f"stream produced more than the "
                                     f"declared {W} windows")
                for name in EventWindow._fields:
                    files[name].write(
                        np.ascontiguousarray(getattr(stacked, name))
                        .tobytes())
        finally:
            for f in files.values():
                f.close()
        for name in EventWindow._fields:
            field = getattr(spec, name)
            shape = (W,) + field.shape
            with zf.open(f"w/{name}.npy", "w", force_zip64=True) as fid:
                _npformat._write_array_header(
                    fid, {"descr": _npformat.dtype_to_descr(field.dtype),
                          "fortran_order": False, "shape": shape})
                with open(paths[name], "rb") as src:
                    shutil.copyfileobj(src, fid, 1 << 20)
        return seen
    finally:
        shutil.rmtree(spool_dir, ignore_errors=True)


def _write_stack_legacy(tmp: str, cfg: SimConfig,
                        stream: Iterable[EventWindow], W: int,
                        shard_windows: int):
    """The pre-streaming writer: materialise everything, one savez call.

    Kept as the bitwise oracle for the streaming writer and as the
    ingest benchmark's peak-RSS baseline — peak host memory is O(trace).
    """
    windows = list(stream)
    if len(windows) != W:
        raise ValueError(f"stream produced {len(windows)} windows, "
                         f"declared {W}")
    stacked = stack_windows(windows)
    meta = _build_meta(cfg, W, shard_windows)
    if shard_windows:
        starts = list(range(0, W, shard_windows)) + [W]
        data = {_chunk_key(c, name): getattr(stacked, name)[lo:hi]
                for c, (lo, hi) in enumerate(zip(starts, starts[1:]))
                for name in EventWindow._fields}
    else:
        data = {f"w/{name}": getattr(stacked, name)
                for name in EventWindow._fields}
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **meta, **data)


def precompile_stream(cfg: SimConfig, stream: Iterable[EventWindow],
                      out_path: str, n_windows: int,
                      shard_windows: int = DEFAULT_SHARD_WINDOWS,
                      parse_stats=None, streaming: bool = True) -> int:
    """Persist an EventWindow stream (exactly ``n_windows`` long) to npz.

    ``streaming=True`` (default) holds one ``shard_windows`` chunk in RAM;
    ``streaming=False`` is the legacy materialise-everything writer — both
    produce bitwise-identical archives. ``parse_stats`` (a ParseStats) is
    embedded into the meta after the stream is exhausted.

    The write is **crash-safe**: everything lands in a uniquely-named temp
    file in the target directory, fsync'd, then atomically renamed into
    place — a crash (or an armed ``precompile_write`` fault) at any point
    leaves *no file at the target path*, so a partial stack can never
    masquerade as a complete one. Per-member crc32s are embedded last (see
    :func:`verify_stack`).
    """
    out_dir = os.path.dirname(out_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    # unique temp name (mkstemp) so concurrent writers never clobber each
    # other's half-written archives; same directory so the rename is atomic
    fd, tmp = tempfile.mkstemp(dir=out_dir,
                               prefix=os.path.basename(out_path) + ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        if streaming:
            _write_stack_streaming(tmp, cfg, stream, n_windows,
                                   shard_windows)
        else:
            _write_stack_legacy(tmp, cfg, stream, n_windows, shard_windows)
        if parse_stats is not None:
            _append_parse_stats(tmp, parse_stats)
        _append_byte_index(tmp)
        _append_member_crcs(tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, out_path)
        try:                                   # persist the rename itself
            dfd = os.open(out_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass                               # platform without dir fsync
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return n_windows


def precompile_trace(cfg: SimConfig, trace_dir: str, out_path: str,
                     n_windows: int, start_us: int = 0,
                     shard_windows: int = DEFAULT_SHARD_WINDOWS,
                     family: str = "gcd", streaming: bool = True) -> int:
    """Parse once, persist the packed window stack. Returns windows written.

    ``shard_windows`` sets the chunking granularity of the row/byte index
    (one zip member group per chunk); 0 writes the legacy single-member
    layout (no sub-range loads, but still replayable). ``family`` selects
    the trace parser from the registry (``gcd``, ``openb``, plugins). The
    parse never materialises the trace: windows stream from the parser
    straight into the archive, one chunk in RAM at a time.
    """
    from repro_torch.parsers import get_parser
    parser = get_parser(family)(cfg, trace_dir)
    stream = parser.packed_windows(n_windows, start_us=start_us)
    return precompile_stream(cfg, stream, out_path, n_windows,
                             shard_windows=shard_windows,
                             parse_stats=parser.stats, streaming=streaming)


class _Layout:
    """Resolved stack layout: chunk row starts (chunked) or None (flat)."""

    def __init__(self, z):
        if "meta/window_index" in z.files:
            self.starts = np.asarray(z["meta/window_index"], np.int64)
            self.n_windows = int(self.starts[-1])
        else:
            self.starts = None
            self.n_windows = int(z["w/kind"].shape[0])

    def pieces(self, z, lo: int, hi: int) -> Iterator[EventWindow]:
        """Yield (w, ...) row runs covering [lo, hi), touching only the
        chunks that overlap the range."""
        if lo >= hi:
            return
        if self.starts is None:                # legacy flat stack
            yield EventWindow(*[np.asarray(z[f"w/{name}"][lo:hi])
                                for name in EventWindow._fields])
            return
        starts = self.starts
        c0 = int(np.searchsorted(starts, lo, side="right")) - 1
        for c in range(c0, len(starts) - 1):
            clo, chi = int(starts[c]), int(starts[c + 1])
            if clo >= hi:
                break
            a, b = max(lo, clo) - clo, min(hi, chi) - clo
            yield EventWindow(*[np.asarray(z[_chunk_key(c, name)][a:b])
                                for name in EventWindow._fields])


def _rebatch(pieces: Iterator[EventWindow], batch: int
             ) -> Iterator[EventWindow]:
    """Regroup arbitrary row runs into exact ``batch``-row stacks (+ tail).

    The batch size, not the chunking, decides the device-batch geometry —
    so replay results are independent of the writer's ``shard_windows``.
    """
    buf: List[EventWindow] = []
    have = 0
    for p in pieces:
        buf.append(p)
        have += p.kind.shape[0]
        while have >= batch:
            out, taken, rest = [], 0, []
            for q in buf:
                need = batch - taken
                k = q.kind.shape[0]
                if need == 0:
                    rest.append(q)
                elif k <= need:
                    out.append(q)
                    taken += k
                else:
                    out.append(EventWindow(*[x[:need] for x in q]))
                    rest.append(EventWindow(*[x[need:] for x in q]))
                    taken += need
            buf, have = rest, have - batch
            if len(out) == 1:
                yield out[0]
            else:
                yield EventWindow(*[np.concatenate(cols)
                                    for cols in zip(*out)])
    if buf:
        if len(buf) == 1:
            yield buf[0]
        else:
            yield EventWindow(*[np.concatenate(cols) for cols in zip(*buf)])


def stack_n_windows(path: str) -> int:
    """Total windows persisted in a pre-compiled stack."""
    with np.load(path, mmap_mode="r") as z:
        return _Layout(z).n_windows


def stack_parse_stats(path: str) -> Optional[dict]:
    """The ParseStats the stack was written under (None for old stacks).

    At paper scale a non-zero ``slot_overflow`` means the parser silently
    dropped tasks — every replay consumer should check, not just the
    process that ran the parse.
    """
    with np.load(path, mmap_mode="r") as z:
        if "meta/parse_stats" not in z.files:
            return None
        names = [str(s) for s in z["meta/parse_stats_names"]]
        vals = [int(v) for v in z["meta/parse_stats"]]
    return dict(zip(names, vals))


def overflow_warning(stats) -> Optional[str]:
    """A human warning when the parse dropped data, else None.

    ``stats`` is a ParseStats or a :func:`stack_parse_stats` dict.
    """
    if stats is None:
        return None
    get = stats.get if isinstance(stats, dict) else \
        lambda k, d=0: getattr(stats, k, d)
    slot, attr = int(get("slot_overflow", 0)), int(get("attr_overflow", 0))
    if not slot and not attr:
        return None
    parts = []
    if slot:
        parts.append(f"{slot} task/node rows dropped (slot_overflow) — "
                     "results are missing load; raise max_tasks/max_nodes")
    if attr:
        parts.append(f"{attr} attribute names hashed into shared columns "
                     "(attr_overflow) — constraints may alias; raise "
                     "n_attr_slots")
    return "WARNING: " + "; ".join(parts)


def stack_member_crcs(path: str) -> Optional[dict]:
    """member name -> crc32 of its decompressed npy bytes (None for stacks
    written before checksums were embedded)."""
    with np.load(path, mmap_mode="r") as z:
        if "meta/member_crc" not in z.files:
            return None
        names = [str(s) for s in z["meta/member_crc_names"]]
        vals = [int(v) for v in z["meta/member_crc"]]
    return dict(zip(names, vals))


def _member_label(name: str) -> str:
    """'w/00002/kind' -> a human label carrying the chunk index."""
    parts = name.split("/")
    if len(parts) == 3 and parts[1].isdigit():
        return f"chunk {int(parts[1])} member {name!r}"
    return f"member {name!r}"


def _chunk_member_names(path: str, lo: Optional[int],
                        hi: Optional[int]) -> List[str]:
    """Data members overlapping windows [lo, hi) (all of them when the
    bounds are None or the stack is flat)."""
    with np.load(path, mmap_mode="r") as z:
        layout = _Layout(z)
        if layout.starts is None or lo is None or hi is None:
            return [k for k in z.files if k.startswith("w/")]
        starts = layout.starts
        c0 = max(0, int(np.searchsorted(starts, lo, side="right")) - 1)
        names = []
        for c in range(c0, len(starts) - 1):
            if int(starts[c]) >= hi:
                break
            names += [_chunk_key(c, f) for f in EventWindow._fields]
        return names


def verify_stack(path: str, lo: Optional[int] = None,
                 hi: Optional[int] = None):
    """Check the embedded per-member crc32s (optionally only the chunks
    overlapping windows [lo, hi)). Raises :class:`StackCorruptionError`
    naming the corrupt chunk — truncated, bit-flipped and unreadable members
    all surface with their index, eagerly, instead of as a generic zlib
    error (or worse, silence) mid-replay."""
    crcs = stack_member_crcs(path)
    if crcs is None:
        raise ValueError(f"stack {path} has no embedded member checksums "
                         f"(written before crc32 meta) — re-run "
                         f"precompile_trace to verify integrity")
    names = _chunk_member_names(path, lo, hi)
    try:
        zf = zipfile.ZipFile(path)
    except zipfile.BadZipFile as e:
        raise StackCorruptionError(
            f"corrupt stack {path}: archive unreadable ({e})") from e
    with zf:
        for name in names:
            want = crcs.get(name)
            if want is None:
                raise StackCorruptionError(
                    f"corrupt stack {path}: {_member_label(name)} has no "
                    f"recorded checksum")
            try:
                data = zf.read(name + ".npy")
            except Exception as e:             # zlib / zip CRC / truncation
                raise StackCorruptionError(
                    f"corrupt stack {path}: {_member_label(name)} "
                    f"unreadable ({type(e).__name__}: {e})") from e
            data = maybe_corrupt("chunk_read", data)
            got = zlib.crc32(data)
            if got != want:
                raise StackCorruptionError(
                    f"corrupt stack {path}: {_member_label(name)} crc32 "
                    f"{got:#010x} != recorded {want:#010x} — the chunk's "
                    f"bytes changed since precompile_trace wrote them")


def replay_index(path: str) -> dict:
    """The stack's row + byte index (None entries for legacy flat stacks).

    ``chunk_starts``: int64 (n_chunks + 1,) row offsets — chunk c holds
    windows [starts[c], starts[c+1]). ``members``: zip-member name ->
    (header_offset, compressed_size) byte span inside the npz.
    """
    with np.load(path, mmap_mode="r") as z:
        out = {"n_windows": _Layout(z).n_windows,
               "chunk_starts": None, "members": None}
        if "meta/window_index" in z.files:
            out["chunk_starts"] = np.asarray(z["meta/window_index"], np.int64)
        if "meta/byte_index" in z.files:
            names = [str(s) for s in z["meta/byte_index_names"]]
            spans = [tuple(int(v) for v in row) for row in z["meta/byte_index"]]
            out["members"] = dict(zip(names, spans))
    return out


def load_window_range(path: str, lo: int, hi: int,
                      verify: bool = False) -> EventWindow:
    """One (hi-lo, ...) stacked EventWindow, decompressing only the chunks
    that overlap [lo, hi) — the fork-point fast path. ``verify`` checks the
    touched chunks' crc32s first (StackCorruptionError names the chunk)."""
    if verify:
        verify_stack(path, lo, hi)
    with np.load(path, mmap_mode="r") as z:
        layout = _Layout(z)
        if not 0 <= lo <= hi <= layout.n_windows:
            raise ValueError(f"window range [{lo}, {hi}) outside the stack's "
                             f"[0, {layout.n_windows})")
        pieces = list(layout.pieces(z, lo, hi))
    if len(pieces) == 1:
        return pieces[0]
    if not pieces:
        raise ValueError("empty window range")
    return EventWindow(*[np.concatenate(cols) for cols in zip(*pieces)])


def validate_replay(path: str, cfg: SimConfig, verify: bool = False):
    """Raise if a pre-compiled stack doesn't match ``cfg``'s window layout.

    Stacks from before the metadata was embedded are accepted as long as
    both sides agree there is no injection slot pool. ``verify=True``
    additionally checks every data member against its embedded crc32
    (:func:`verify_stack`) — the full-integrity gate before trusting a stack
    that crossed a network or sat on disk for a month.
    """
    if verify:
        verify_stack(path)
    with np.load(path, mmap_mode="r") as z:
        has_meta = any(k == f"meta/{_META_FIELDS[0]}" for k in z.files)
        mismatches = {}
        for name in _META_FIELDS:
            want = int(getattr(cfg, name))
            got = int(z[f"meta/{name}"]) if has_meta else \
                (z["w/kind"].shape[1] if name == "max_events_per_window"
                 else (0 if name in ("inject_slots", "inject_task_slots")
                       else want))
            if got != want:
                mismatches[name] = (got, want)
    if mismatches:
        detail = ", ".join(f"{k}: stack has {g}, config wants {w}"
                           for k, (g, w) in mismatches.items())
        raise ValueError(f"pre-compiled stack {path} doesn't match the "
                         f"config ({detail}) — re-run precompile_trace")


def replay_config(path: str, cfg: SimConfig) -> SimConfig:
    """``cfg`` with the stack's embedded window geometry applied.

    A replay consumer cannot re-shape persisted tensors, so the writer's
    layout (event rows, injection pool, column counts) wins over whatever
    the consumer configured — this is how the CLI's ``--replay`` mode
    guarantees ``validate_replay`` passes. Pre-metadata stacks are assumed
    to have been written without an injection pool.
    """
    with np.load(path, mmap_mode="r") as z:
        if not any(k == f"meta/{_META_FIELDS[0]}" for k in z.files):
            return dataclasses.replace(
                cfg, max_events_per_window=int(z["w/kind"].shape[1]),
                inject_slots=0, inject_task_slots=0)
        over = {name: int(z[f"meta/{name}"]) for name in _META_FIELDS}
    return dataclasses.replace(cfg, **over)


def replay_windows(path: str, batch: int = 32,
                   n_windows: Optional[int] = None,
                   start_window: int = 0,
                   verify: bool = False) -> Iterator[EventWindow]:
    """Stream (batch, ...) stacks straight from the persisted tensors (zero
    parsing), optionally truncated to ``n_windows`` windows starting at
    ``start_window``. On a chunked stack only the chunks overlapping the
    requested range are ever decompressed.

    An out-of-range ``start_window`` raises ValueError (matching
    :func:`load_window_range`) instead of silently yielding nothing — a
    typo'd ``--start-window`` must not look like an empty trace. The check
    is eager (this is a plain function returning a generator), so callers
    that hand the stream to a prefetcher thread still fail on *their*
    thread, at call time. ``verify=True`` is just as eager: the requested
    range's chunks are checksum-verified *here*, before a single window is
    yielded, so a corrupt chunk fails the caller with its index instead of
    crashing a prefetcher thread mid-run.
    """
    if start_window < 0:
        raise ValueError(f"start_window={start_window} must be >= 0")
    n = stack_n_windows(path)
    if start_window >= n and not (start_window == 0 and n == 0):
        raise ValueError(
            f"start_window={start_window} outside the stack's "
            f"[0, {n}) — nothing left to replay")
    if verify:
        hi = n if n_windows is None else min(n, start_window + n_windows)
        verify_stack(path, start_window, hi)
    return _replay_iter(path, batch, n_windows, start_window)


def _replay_iter(path: str, batch: int, n_windows: Optional[int],
                 start_window: int) -> Iterator[EventWindow]:
    with np.load(path, mmap_mode="r") as z:
        layout = _Layout(z)
        lo = start_window
        hi = layout.n_windows if n_windows is None else \
            min(layout.n_windows, lo + n_windows)
        yield from _rebatch(layout.pieces(z, lo, hi), batch)


def replay_single_windows(path: str) -> Iterator[EventWindow]:
    for b in replay_windows(path, batch=1):
        yield EventWindow(*[np.asarray(v[0]) for v in b])
