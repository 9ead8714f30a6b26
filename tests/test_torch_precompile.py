"""The port's pre-compiled stacks (``repro_torch.core.precompile``), the
checks of the reference's ``tests/test_precompile_index.py``: window/byte
index, sub-range loads, start_window replay, legacy flat-layout
compatibility, and checksum verification of corrupted archives (bit rot
must fail eagerly, naming the corrupt chunk). Across the packages: the same
trace pre-compiles to the same bytes in both, and a stack written by either
replays in the other."""
import os
import shutil
import struct
import tempfile
import zipfile

import numpy as np
import pytest

from repro_torch.config import REDUCED_SIM
from repro_torch.core.events import EventWindow, stack_windows
from repro_torch.core.precompile import (StackCorruptionError, load_window_range,
                                   precompile_trace, replay_index,
                                   replay_windows, stack_member_crcs,
                                   stack_n_windows, validate_replay,
                                   verify_stack)
from repro_torch.core.tracegen import SHIFT_US, generate_trace
from repro_torch.parsers.gcd import GCDParser

CFG = REDUCED_SIM
START = SHIFT_US - CFG.window_us
N = 25


@pytest.fixture(scope="module")
def stacks():
    """One trace, persisted chunked (shard 8) and flat (legacy layout), by
    the port and by the reference."""
    from repro.config import REDUCED_SIM as REF_CFG
    from repro.core.precompile import precompile_trace as ref_precompile
    with tempfile.TemporaryDirectory() as d:
        generate_trace(d, n_machines=16, n_jobs=30, horizon_windows=N,
                       seed=3, usage_period_us=10_000_000)
        chunked = os.path.join(d, "chunked.npz")
        flat = os.path.join(d, "flat.npz")
        precompile_trace(CFG, d, chunked, N, start_us=START, shard_windows=8)
        precompile_trace(CFG, d, flat, N, start_us=START, shard_windows=0)
        for name, shard in (("chunked", 8), ("flat", 0)):
            ref_precompile(REF_CFG, d, os.path.join(d, f"ref_{name}.npz"),
                           N, start_us=START, shard_windows=shard)
        parsed = stack_windows(
            list(GCDParser(CFG, d).packed_windows(N, start_us=START)))
        yield chunked, flat, parsed


def _full(path, batch=32):
    return stack_windows([w for b in replay_windows(path, batch=batch)
                          for w in [EventWindow(*[np.asarray(x[i])
                                                  for x in b])
                                    for i in range(b.kind.shape[0])]])


def test_chunked_roundtrip_matches_parser(stacks):
    chunked, flat, parsed = stacks
    for path in (chunked, flat):
        validate_replay(path, CFG)
        assert stack_n_windows(path) == N
        got = _full(path)
        for f in EventWindow._fields:
            assert np.array_equal(getattr(got, f), getattr(parsed, f)), f


def test_chunked_equals_flat_any_batch(stacks):
    """Replay batching is independent of the writer's shard_windows."""
    chunked, flat, _ = stacks
    for batch in (1, 7, 8, 32):
        a = list(replay_windows(chunked, batch=batch))
        b = list(replay_windows(flat, batch=batch))
        assert len(a) == len(b)
        sizes = [x.kind.shape[0] for x in a]
        assert sizes == [batch] * (N // batch) + \
            ([N % batch] if N % batch else [])
        for x, y in zip(a, b):
            for f in EventWindow._fields:
                assert np.array_equal(getattr(x, f), getattr(y, f)), f


def test_load_window_range(stacks):
    chunked, _, parsed = stacks
    for lo, hi in ((0, 8), (5, 13), (7, 9), (16, 25), (0, 25), (24, 25)):
        got = load_window_range(chunked, lo, hi)
        assert got.kind.shape[0] == hi - lo
        for f in EventWindow._fields:
            assert np.array_equal(getattr(got, f),
                                  getattr(parsed, f)[lo:hi]), (f, lo, hi)
    with pytest.raises(ValueError):
        load_window_range(chunked, 0, N + 1)
    with pytest.raises(ValueError):
        load_window_range(chunked, -1, 4)


def test_start_window_replay_equals_skip(stacks):
    chunked, _, parsed = stacks
    got = _full_from(chunked, start=9, n=12)
    for f in EventWindow._fields:
        assert np.array_equal(getattr(got, f), getattr(parsed, f)[9:21]), f


def _full_from(path, start, n):
    pieces = list(replay_windows(path, batch=5, n_windows=n,
                                 start_window=start))
    return EventWindow(*[np.concatenate(cols) for cols in zip(*pieces)])


def test_window_index_meta(stacks):
    chunked, flat, _ = stacks
    idx = replay_index(chunked)
    assert idx["n_windows"] == N
    assert list(idx["chunk_starts"]) == [0, 8, 16, 24, 25]
    assert replay_index(flat)["chunk_starts"] is None


def test_byte_index_matches_zip_truth(stacks):
    """The embedded byte spans agree with the archive's real layout, so an
    external reader could range-request exactly one chunk."""
    chunked, _, _ = stacks
    members = replay_index(chunked)["members"]
    assert members
    with zipfile.ZipFile(chunked) as zf:
        real = {i.filename[:-len(".npy")]: (i.header_offset, i.compress_size)
                for i in zf.infolist() if i.filename.startswith("w/")}
    assert members == real
    assert all(k.startswith("w/") for k in members)


def test_member_crcs_embedded_and_verified(stacks):
    chunked, flat, _ = stacks
    for path in (chunked, flat):
        crcs = stack_member_crcs(path)
        assert crcs and all(k.startswith("w/") for k in crcs)
        verify_stack(path)                     # pristine: no complaint
        validate_replay(path, CFG, verify=True)
    # chunked stacks checksum per chunk member
    assert "w/00001/kind" in stack_member_crcs(chunked)


def _corrupt_member(src: str, dst: str, member: str, mode: str):
    """Copy ``src`` to ``dst`` and rot ``member``'s compressed bytes — a
    mid-stream bit flip, or a zeroed tail half ("truncation" that keeps the
    zip central directory intact, so the reader can still name the chunk)."""
    shutil.copyfile(src, dst)
    off, sz = replay_index(src)["members"][member]
    with open(dst, "r+b") as f:
        f.seek(off + 26)                       # local header: name/extra lens
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        data_start = off + 30 + name_len + extra_len
        if mode == "bitflip":
            f.seek(data_start + sz // 2)
            b = f.read(1)[0]
            f.seek(data_start + sz // 2)
            f.write(bytes([b ^ 0xFF]))
        else:                                  # truncate
            f.seek(data_start + sz // 2)
            f.write(b"\x00" * (sz - sz // 2))


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corrupt_chunk_detected_by_index(stacks, tmp_path, mode):
    chunked, _, _ = stacks
    bad = str(tmp_path / f"{mode}.npz")
    _corrupt_member(chunked, bad, "w/00001/kind", mode)
    # eager verification names the corrupt chunk
    with pytest.raises(StackCorruptionError, match="chunk 1"):
        verify_stack(bad)
    with pytest.raises(StackCorruptionError, match="chunk 1"):
        validate_replay(bad, CFG, verify=True)
    # replay over the corrupt range fails EAGERLY — at call time, before a
    # single window is yielded (not mid-iteration on a prefetcher thread)
    with pytest.raises(StackCorruptionError, match="chunk 1"):
        replay_windows(bad, batch=8, start_window=8, verify=True)
    with pytest.raises(StackCorruptionError, match="chunk 1"):
        load_window_range(bad, 8, 16, verify=True)
    # ranges that never touch chunk 1 (windows [8, 16)) stay servable
    got = load_window_range(bad, 0, 8, verify=True)
    assert got.kind.shape[0] == 8
    assert sum(b.kind.shape[0] for b in
               replay_windows(bad, batch=8, n_windows=8, verify=True)) == 8


def test_fleet_from_precompiled_start_window(stacks):
    """The runner-level fast path: a fleet fed from window W sees exactly
    the suffix windows (state continuity is test_fleet_snapshot_resume_*)."""
    chunked, _, parsed = stacks
    from repro_torch.scenarios import ScenarioFleet, ScenarioSpec
    fleet = ScenarioFleet.from_precompiled(
        CFG, chunked, [ScenarioSpec()], batch_windows=8, start_window=16,
        device="cpu")
    fleet.run()
    assert fleet.windows_done == N - 16


# --- across the packages -------------------------------------------------------

def test_both_packages_write_the_same_bytes(stacks):
    chunked, flat, _ = stacks
    d = os.path.dirname(chunked)
    for path in (chunked, flat):
        with open(path, "rb") as a, open(os.path.join(
                d, "ref_" + os.path.basename(path)), "rb") as b:
            assert a.read() == b.read(), path


def test_stacks_replay_in_the_other_package(stacks):
    """A stack of the reference replays here (and verifies), and the
    port's replays in the reference, window for window."""
    from repro.core.precompile import replay_windows as ref_replay
    from repro.core.precompile import verify_stack as ref_verify
    chunked, _, parsed = stacks
    ref_chunked = os.path.join(os.path.dirname(chunked), "ref_chunked.npz")
    verify_stack(ref_chunked)
    ref_verify(chunked)
    for got in (_full(ref_chunked),
                stack_windows([EventWindow(*[np.asarray(x[i]) for x in b])
                               for b in ref_replay(chunked, batch=8)
                               for i in range(b.kind.shape[0])])):
        for f in EventWindow._fields:
            assert np.array_equal(getattr(got, f), getattr(parsed, f)), f
    got = load_window_range(ref_chunked, 9, 21)
    for f in EventWindow._fields:
        assert np.array_equal(getattr(got, f), getattr(parsed, f)[9:21]), f
