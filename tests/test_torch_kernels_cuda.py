"""The CUDA kernels against their plain versions, on the card, at shapes
that are not tile multiples and with more than one lane (kernel D with mixed
families and per-lane modes, kernel B's per-lane flag, kernel A's lane
axis; kernel F in f32 and bf16, causal and full, head dims 16-128, S a
multiple of the tile or not, strided inputs, which body serves which call,
misaligned inputs refused); B and D past the node count one block's shared
memory once held (12,500, 20,000 and 150,000 nodes, every mode and family,
R from 1 to 6); the engine and the scenario fleet (both dispatch paths),
the LM serving path with kernel F, kernel E's lane form (B=1 and 8, V of
1-12, skewed and empty cases, one to four digit passes, and off-grid data
at cell-A shape against the host's task-order f32 sum, and at the
searches' surrogate shape: T=1,024 tasks into 12,500 nodes, B=1 and the
GA's B=8), the key stream's draws (card against CPU, bitwise, one key and a key a
row, drawn in many small chunks of the flat index), the four stochastic
schedulers through the engine, and kernel G (the
fused cross-entropy: small ragged shapes, which body serves which call,
qwen3-4b's training shape, the gradients of the loss built on it, one
train step), on the card against the CPU path or the plain version.
Skipped without a CUDA device; on the card (where JAX, which
tests/conftest.py imports, need not be installed):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Bar: integers exact, grid-data sums and scores bitwise, variances within
rtol 2.5e-7; kernel F within 1e-5 (f32) and 2e-2 (bf16) of its plain
version, the reference's own attention bar; kernel G's per-token nll and
lse within 1e-4 of its plain version (both take f32 products of the
operands; only the order of the sums differs; 2e-3 at the training shape,
where each logit sums 2,560 products), its loss gradients within 1e-5 (f32)
and 1e-2 of the largest gradient (bf16) of autograd through the plain
chunked loss, one train step's loss within 1e-4 of the CPU's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import REDUCED_SIM
from repro_torch.core import engine
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import init_state, state_to_numpy
from repro_torch.kernels.constraint_match import ops as cm_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.fused_ce.ref import fused_ce_ref
from repro_torch.kernels.constraint_match.ref import constraint_match_ref
from repro_torch.kernels.placement_commit import ops as pc_ops
from repro_torch.kernels.placement_commit.ref import (placement_commit_ref,
                                                      sched_commit_fleet_ref)
from repro_torch.kernels.segment_usage import ops as su_ops
from repro_torch.kernels.segment_usage.ref import (segment_usage_lanes_ref,
                                                   segment_usage_ref)
from repro_torch.kernels.window_stats import ops as ws_ops
from repro_torch.kernels.window_stats.ref import window_reductions_ref
from repro_torch.sched import get_scheduler

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _g(r, lo, hi, shape):
    return torch.from_numpy((r.integers(lo, hi, shape) / 128)
                            .astype(np.float32))


def _wide(r, shape, zeros=0.02):
    """Magnitudes 2^-50 .. 2^50 (inside and outside the range the kernel's
    hoisted-reciprocal divide takes), with +0 and -0 sprinkled in."""
    v = np.exp2(r.uniform(-50, 50, shape)) * r.uniform(0.5, 2.0, shape)
    v[r.random(shape) < zeros] = 0.0
    v[r.random(shape) < zeros] = -0.0
    return torch.from_numpy(v.astype(np.float32))


# (B, P, N, C, K, share of inactive nodes, values): tiles of 32 tasks x
# 512 nodes cut anywhere, rows that do not start on 16 bytes (N % 4 != 0,
# N=12,501), no and 16 constraint slots, K of 13 (no 16-byte attribute
# rows) and 64, every node inactive, the fleet's B=8 at cell A's width;
# "wide" values spread over 100 binades (both divide paths, bitwise)
@pytest.mark.parametrize("B,P,N,C,K,dead,values", [
    (1, 1, 1, 6, 16, 0.2, "grid"), (1, 7, 129, 6, 16, 0.2, "grid"),
    (1, 130, 300, 6, 16, 0.2, "grid"), (3, 9, 140, 6, 16, 0.2, "grid"),
    (1, 33, 513, 6, 16, 0.2, "grid"), (1, 40, 12501, 6, 16, 0.2, "grid"),
    (2, 37, 700, 0, 16, 0.2, "grid"), (2, 37, 700, 16, 16, 0.2, "grid"),
    (1, 50, 600, 6, 13, 0.2, "grid"), (1, 64, 1000, 6, 64, 0.2, "grid"),
    (2, 20, 300, 6, 16, 1.0, "grid"), (8, 1024, 12500, 6, 16, 0.05, "grid"),
    (1, 300, 3001, 0, 16, 0.05, "wide"),
    (2, 1024, 12500, 6, 16, 0.05, "wide")])
def test_constraint_match(dev, B, P, N, C, K, dead, values):
    r = np.random.default_rng(B + P + N + C + K)
    imin, imax = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    vals = r.integers(0, 4, (B, P, C))
    vals[r.random((B, P, C)) < 0.05] = imin    # LT/GT with nothing below
    vals[r.random((B, P, C)) < 0.05] = imax    # or above
    attrs = r.integers(0, 4, (B, N, K))
    attrs[r.random((B, N, K)) < 0.02] = imin
    attrs[r.random((B, N, K)) < 0.02] = imax
    cons = torch.from_numpy(np.stack(
        [r.integers(-K - 2, K + 2, (B, P, C)), r.integers(0, 6, (B, P, C)),
         vals], -1).astype(np.int32))
    if values == "grid":
        req, total = _g(r, 1, 48, (B, P, 3)), _g(r, 16, 256, (B, N, 3))
        reserved = _g(r, 0, 160, (B, N, 3))
    else:                   # free below, at and above the requests
        req, total = _wide(r, (B, P, 3)), _wide(r, (B, N, 3))
        reserved = total * torch.from_numpy(
            r.choice([0.0, 0.5, 1.0, 1.5], (B, N, 3)).astype(np.float32))
    args = [x.to(dev) for x in (
        req, cons, total, reserved, torch.from_numpy(attrs.astype(np.int32)),
        torch.from_numpy(r.random((B, N)) >= dead))]
    if B == 1:
        args = [x[0] for x in args]
    before = cm_ops.constraint_match_cuda.launches
    got = cm_ops.constraint_match(*args)
    assert cm_ops.constraint_match_cuda.launches == before + 1
    for b in range(B):
        lane = args if B == 1 else [x[b] for x in args]
        want = constraint_match_ref(*lane)
        assert torch.equal(got if B == 1 else got[b], want)
    if dead == 1.0:
        assert bool(torch.isneginf(got).all())
    if values == "wide":    # both divide paths ran on feasible pairs
        assert bool(torch.isfinite(got).any())


@pytest.mark.parametrize("mode", ["static", "dynamic", "both"])
@pytest.mark.parametrize("B,P,N", [(1, 5, 7), (3, 64, 1500)])
def test_placement_commit_lanes(dev, mode, B, P, N):
    r = np.random.default_rng(B * P + N)
    total = _g(r, 16, 256, (B, N, 3))
    active = torch.from_numpy(r.random((B, N)) < 0.8)
    ops = [_g(r, -256, 0, (B, P, N)), _g(r, 1, 64, (B, P, 3)),
           torch.from_numpy(r.random((B, P, N)) < 0.7),
           torch.from_numpy(r.random((B, P)) < 0.85),
           torch.where(active[..., None], total, -1.0),
           torch.clamp_min(total, 1e-6), _g(r, 0, 96, (B, N, 3))]
    ops = [x.to(dev) for x in ops]
    flags = torch.from_numpy(np.arange(B) % 2 == 0).to(dev)
    if mode == "both":
        ops[1] = ops[1][:1].contiguous()       # a lane-shared request matrix
    node_of, tally = pc_ops.placement_commit_cuda(*ops, mode, flags)
    for b in range(B):
        dyn = bool(flags[b]) if mode == "both" else mode == "dynamic"
        want_n, want_t = placement_commit_ref(
            *[x[b if x.shape[0] > 1 else 0] for x in ops], dyn)
        assert torch.equal(node_of[b], want_n)
        assert torch.equal(tally[b], want_t)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dyn", [(False,) * 4, (True,) * 4,
                                 (True, False, False, True)],
                         ids=["static", "dynamic", "both"])
@pytest.mark.parametrize("P,N", [(5, 7), (64, 1500)])
def test_sched_commit_mixed_families(dev, P, N, dyn, shared):
    """Kernel D: lanes of every family (scores, node order from a rotating
    start, two external rows) against sched_pref_ref -> placement_commit_ref
    per lane; with ``shared`` the lanes share total/denom/reserved0."""
    r = np.random.default_rng(P + N)
    fam = (pc_ops.FAM_SCORES, pc_ops.FAM_NODE_ORDER, pc_ops.FAM_EXTERNAL,
           pc_ops.FAM_EXTERNAL)
    ext_row = (0, 0, 1, 0)
    B = len(fam)
    total = _g(r, 16, 256, (B, N, 3))
    active = torch.from_numpy(r.random((B, N)) < 0.8)
    ok = torch.from_numpy(r.random((B, P, N)) < 0.7)
    scores = torch.where(ok, _g(r, -256, 0, (B, P, N)), float("-inf"))
    ops = [scores, ok, _g(r, 1, 64, (B, P, 3)),
           torch.from_numpy(r.random((B, P)) < 0.85),
           torch.where(active[..., None], total, -1.0),
           torch.clamp_min(total, 1e-6), _g(r, 0, 96, (B, N, 3))]
    if shared:
        ops[4:] = [x[:1] for x in ops[4:]]
    ops = [x.contiguous().to(dev) for x in ops]
    ext = _g(r, -64, 64, (2, P, N)).to(dev)
    start = torch.tensor([0, N // 3, 0, 0], dtype=torch.int32, device=dev)
    before = pc_ops.sched_commit_cuda.launches
    node_of, tally = pc_ops.sched_commit_fleet(
        *ops, start, fam=fam, dynamic=dyn, ext=ext, ext_row=ext_row)
    assert pc_ops.sched_commit_cuda.launches == before + 1
    want_n, want_t = pc_ops.sched_commit_fleet(
        *[x.cpu() for x in ops], start.cpu(), fam=fam, dynamic=dyn,
        ext=ext.cpu(), ext_row=ext_row)
    assert torch.equal(node_of.cpu(), want_n)
    assert torch.equal(tally.cpu(), want_t)


def _commit_ops(r, B, P, N, R=3):
    """The commit scan's operands on grid data: pref, req, ok, valid,
    total (inactive nodes folded to -1), denom, reserved0."""
    total = _g(r, 16, 256, (B, N, R))
    active = torch.from_numpy(r.random((B, N)) < 0.8)
    return [_g(r, -256, 0, (B, P, N)), _g(r, 1, 64, (B, P, R)),
            torch.from_numpy(r.random((B, P, N)) < 0.7),
            torch.from_numpy(r.random((B, P)) < 0.85),
            torch.where(active[..., None], total, -1.0),
            torch.clamp_min(total, 1e-6), _g(r, 0, 96, (B, N, R))]


@pytest.mark.parametrize("mode", ["static", "dynamic", "both"])
@pytest.mark.parametrize("N", [12500, 20000, 150000])
def test_placement_commit_any_n(dev, mode, N):
    """Kernel B past one block's shared memory (the old ceiling was N*R <=
    58,112): cell A's 12,500 nodes (one node a thread, in registers),
    20,000 and 150,000 (further nodes a thread, their tally in memory);
    node_of exact and the tally bitwise against the plain version."""
    B, P = 2, 64
    r = np.random.default_rng(N)
    ops = [x.to(dev) for x in _commit_ops(r, B, P, N)]
    flags = torch.tensor([True, False], device=dev)
    before = pc_ops.placement_commit_cuda.launches
    node_of, tally = pc_ops.placement_commit_cuda(*ops, mode, flags)
    assert pc_ops.placement_commit_cuda.launches == before + 1
    for b in range(B):
        dyn = bool(flags[b]) if mode == "both" else mode == "dynamic"
        want_n, want_t = placement_commit_ref(*[x[b] for x in ops], dyn)
        assert torch.equal(node_of[b], want_n)
        assert torch.equal(tally[b], want_t)
    assert bool((node_of >= 0).any())


@pytest.mark.parametrize("R", [1, 4, 6])
def test_placement_commit_any_r(dev, R):
    """R up to MAX_R = 4 keeps the register node; R = 6 keeps every node
    in memory; both modes, bitwise."""
    B, P, N = 2, 40, 3000
    r = np.random.default_rng(R)
    ops = [x.to(dev) for x in _commit_ops(r, B, P, N, R)]
    flags = torch.tensor([True, False], device=dev)
    node_of, tally = pc_ops.placement_commit_cuda(*ops, "both", flags)
    for b in range(B):
        want_n, want_t = placement_commit_ref(*[x[b] for x in ops],
                                              bool(flags[b]))
        assert torch.equal(node_of[b], want_n)
        assert torch.equal(tally[b], want_t)


@pytest.mark.parametrize("dyn", [(False,) * 4, (True,) * 4,
                                 (True, False, False, True)],
                         ids=["static", "dynamic", "both"])
@pytest.mark.parametrize("N", [12500, 20000, 150000])
def test_sched_commit_any_n(dev, N, dyn):
    """Kernel D's lanes of every family at 12,500, 20,000 and 150,000
    nodes (P=64, R=3), against sched_pref_ref -> placement_commit_ref per
    lane on the card: node_of exact, tally bitwise."""
    P = 64
    r = np.random.default_rng(N + 1)
    fam = (pc_ops.FAM_SCORES, pc_ops.FAM_NODE_ORDER, pc_ops.FAM_EXTERNAL,
           pc_ops.FAM_NODE_ORDER)
    ext_row = (0, 0, 1, 0)
    pref, req, ok, valid, total, denom, res0 = _commit_ops(r, 4, P, N)
    scores = torch.where(ok, pref, float("-inf"))
    ops = [x.to(dev) for x in (scores, ok, req, valid, total, denom, res0)]
    ext = _g(r, -64, 64, (2, P, N)).to(dev)
    start = torch.tensor([0, N // 3, 0, N - 1], dtype=torch.int32,
                         device=dev)
    before = pc_ops.sched_commit_cuda.launches
    node_of, tally = pc_ops.sched_commit_fleet(
        *ops, start, fam=fam, dynamic=dyn, ext=ext, ext_row=ext_row)
    assert pc_ops.sched_commit_cuda.launches == before + 1
    want_n, want_t = sched_commit_fleet_ref(*ops, start, fam, dyn, ext,
                                            ext_row)
    torch.cuda.synchronize()
    assert torch.equal(node_of, want_n)
    assert torch.equal(tally, want_t)


def test_commit_scan_cluster_size(dev):
    """The scan's cluster: 16 or 8 blocks a lane, for B and D, one lane or
    many."""
    for kernel in ("placement_commit", "sched_commit"):
        for lanes in (1, 8, 64):
            assert pc_ops.cluster_size(kernel, lanes) in (8, 16)


# (B, T, N, U, kind): T and N cut anywhere by the 16 chunks of a lane,
# more nodes than the cluster has threads (150,000), U without 16-byte rows
# (3) and above 8 (12), a lane with no active node, off-grid data, and the
# fleet's B=8 at cell A's width
@pytest.mark.parametrize("B,T,N,U,kind", [
    (1, 1000, 77, 8, "grid"), (2, 5000, 1100, 8, "grid"),
    (1, 262147, 12503, 8, "grid"), (1, 3000, 150000, 8, "grid"),
    (1, 5000, 1100, 3, "grid"), (2, 5000, 1100, 12, "grid"),
    (3, 7001, 2000, 8, "no_active_lane"), (2, 70001, 12500, 8, "off_grid"),
    (8, 262144, 12500, 8, "grid")])
def test_window_stats_lanes(dev, B, T, N, U, kind):
    r = np.random.default_rng(T + N + U)
    off = kind == "off_grid"

    def vals(lo, hi, shape):
        if off:
            return torch.from_numpy(r.uniform(lo / 128, hi / 128, shape)
                                    .astype(np.float32))
        return _g(r, lo, hi, shape)

    active = r.random((B, N)) < 0.8
    if kind == "no_active_lane":
        active[1] = False
    ins = [torch.from_numpy(r.integers(0, 3, (B, T)).astype(np.int8)),
           vals(0, 32, (B, T, U)),
           torch.from_numpy(r.integers(-2, 14, (B, T)).astype(np.int32)),
           torch.from_numpy(active), vals(16, 256, (B, N, 3)),
           vals(0, 128, (B, N, 3)), vals(0, 64, (B, N, 3))]
    ins = [x.to(dev) for x in ins]
    before = ws_ops.window_stats_cuda.launches
    outs = ws_ops.window_stats_cuda(*ins)
    assert ws_ops.window_stats_cuda.launches == before + 1
    again = ws_ops.window_stats_cuda(*ins)
    for x, y in zip(outs, again):           # deterministic
        assert torch.equal(x, y)
    counts, by_prio, usum, node_red = outs
    for b in range(B):
        w = window_reductions_ref(*[x[b] for x in ins])
        assert counts[b].tolist() == [int(w.n_running), int(w.n_pending),
                                      int(w.n_nodes)]
        assert torch.equal(by_prio[b], w.by_prio)
        sums = torch.cat([w.usage_sum, w.cap, w.reserved, w.used])
        if off:
            torch.testing.assert_close(torch.cat([usum[b], node_red[b, :9]]),
                                       sums, rtol=1e-5, atol=0)
        else:
            assert torch.equal(torch.cat([usum[b], node_red[b, :9]]), sums)
        torch.testing.assert_close(
            node_red[b, 9:], torch.stack([w.util_var, w.res_var]),
            rtol=2.5e-7, atol=0)
    if kind == "no_active_lane":
        assert counts[1, 2] == 0 and not bool(node_red[1, 9:].any())


@pytest.mark.parametrize("T,N,V", [(5000, 1000, 3), (300, 65, 1),
                                   (2048, 10, 8)])
def test_segment_usage(dev, T, N, V):
    r = np.random.default_rng(T + N + V)
    node = torch.from_numpy(r.integers(-1, N, T).astype(np.int32)).to(dev)
    vals = _g(r, 0, 48, (T, V)).to(dev)
    mask = torch.from_numpy(r.random(T) < 0.6).to(dev)
    assert torch.equal(su_ops.segment_usage(node, vals, mask, N),
                       segment_usage_ref(node, vals, mask, N))


def _su_lanes(r, B, T, N, V, kind):
    """Kernel E's lane-form inputs on grid data: uniform nodes (some -1),
    every task on one node, a Zipf draw over the nodes, or an empty mask."""
    if kind == "one_node":
        node = np.full((B, T), N - 1, np.int32)
    elif kind == "zipf":
        node = np.minimum(r.zipf(1.3, (B, T)) - 1, N - 1).astype(np.int32)
    else:
        node = r.integers(-1, N, (B, T)).astype(np.int32)
    mask = (np.zeros((B, T), bool) if kind == "empty"
            else r.random((B, T)) < 0.7)
    return (torch.from_numpy(node), _g(r, 0, 48, (B, T, V)),
            torch.from_numpy(mask))


@pytest.mark.parametrize("kind", ["uniform", "one_node", "zipf", "empty"])
@pytest.mark.parametrize("V", [1, 3, 6, 8])
@pytest.mark.parametrize("B,T,N", [(1, 5003, 1000), (8, 3001, 12500)])
def test_segment_usage_lanes(dev, B, T, N, V, kind):
    """One launch for all lanes, bitwise against the plain lane form on
    grid data; T a multiple of no tile, skewed and empty cases."""
    r = np.random.default_rng(B * T + V)
    node, vals, mask = (x.to(dev) for x in _su_lanes(r, B, T, N, V, kind))
    before = su_ops.segment_usage_cuda.launches
    got = su_ops.segment_usage_lanes(node, vals, mask, N)
    assert su_ops.segment_usage_cuda.launches == before + 1
    want = segment_usage_lanes_ref(node, vals, mask, N)
    torch.cuda.synchronize()
    assert got.shape == (B, N, V)
    assert torch.equal(got, want)
    if kind == "empty":
        assert not got.any()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_segment_usage_off_grid_is_the_task_order_sum(dev, B, kind):
    """Cell-A shape (T=262,144, N=12,500, V=3), off-grid values: bitwise
    the host's f32 sequential sum in task order (np.add.at)."""
    T, N, V = 262144, 12500, 3
    r = np.random.default_rng(B + len(kind))
    node, _, mask = _su_lanes(r, B, T, N, V, kind)
    vals = r.random((B, T, V), dtype=np.float32)
    got = su_ops.segment_usage_lanes(node.to(dev), torch.from_numpy(vals)
                                     .to(dev), mask.to(dev), N).cpu().numpy()
    for b in range(B):
        keep = mask[b].numpy() & (node[b].numpy() >= 0)
        want = np.zeros((N, V), np.float32)
        np.add.at(want, node[b].numpy()[keep], vals[b][keep])
        np.testing.assert_array_equal(got[b], want)


def test_segment_usage_refuses_what_it_does_not_take(dev):
    """No node, or values that are not f32, are refused; rows wider than
    one group of 8 columns and node ids beyond two 7-bit digits are taken
    (they were refused before the ceilings were lifted)."""
    node = torch.zeros((1, 10), dtype=torch.int32, device=dev)
    mask = torch.ones((1, 10), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):      # no node
        su_ops.segment_usage_lanes(node, torch.zeros((1, 10, 3), device=dev),
                                   mask, 0)
    with pytest.raises(TypeError):       # f64 values
        su_ops.segment_usage_lanes(node, torch.zeros(
            (1, 10, 3), dtype=torch.float64, device=dev), mask, 4)
    vals = torch.arange(90, dtype=torch.float32, device=dev).reshape(1, 10, 9)
    for n_nodes in (4, 16385):           # V = 9; three digit passes
        assert torch.equal(
            su_ops.segment_usage_lanes(node, vals, mask, n_nodes),
            segment_usage_lanes_ref(node, vals, mask, n_nodes))


@pytest.mark.parametrize("B,T,N,V", [(2, 40000, 70000, 12), (1, 3000, 129, 1),
                                     (1, 5000, 128, 9), (2, 20000, 2500000,
                                                         3)])
def test_segment_usage_many_nodes_and_columns(dev, B, T, N, V):
    """Past the old ceilings: 70,000 nodes (three 7-bit passes) with V=12
    (two column groups), one pass (N <= 128), four passes; bitwise against
    the plain lane form on grid data, a Zipf draw crowding low ids and a
    uniform one reaching the top ids."""
    assert su_ops.digit_passes(N) == {70000: 3, 129: 2, 128: 1,
                                      2500000: 4}[N]
    r = np.random.default_rng(N + V)
    for kind in ("zipf", "uniform"):
        node, vals, mask = (x.to(dev) for x in _su_lanes(r, B, T, N, V,
                                                         kind))
        got = su_ops.segment_usage_lanes(node, vals, mask, N)
        want = segment_usage_lanes_ref(node, vals, mask, N)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kind


def _soup(cfg, seed=0, n_windows=12, n_nodes=12, n_slots=80):
    r = np.random.default_rng(seed)
    g = lambda lo, hi: float(r.integers(lo, hi)) / 128
    wins = [[HostEvent(0, EventKind.ADD_NODE, m,
                       a=(g(64, 256), g(64, 256), g(64, 256)))
             for m in range(n_nodes)]]
    for _ in range(n_windows - 1):
        evs = []
        for slot in r.choice(n_slots, 20, replace=False):
            k = int(r.choice([1, 3, 5]))
            if k == 1:
                evs.append(HostEvent(1, EventKind.ADD_TASK, int(slot),
                                     a=(g(1, 48), g(1, 48), g(0, 16)),
                                     prio=int(r.integers(0, 12))))
            elif k == 3:
                evs.append(HostEvent(2, EventKind.UPDATE_TASK_USED, int(slot),
                                     u=tuple(g(0, 32) for _ in range(8))))
            else:
                evs.append(HostEvent(2, EventKind.REMOVE_TASK, int(slot),
                                     a=(0.0, 0, 0)))
        if r.random() < 0.3:
            evs.append(HostEvent(0, EventKind.REMOVE_NODE,
                                 int(r.integers(0, n_nodes))))
        wins.append(evs)
    return stack_windows([pack_window(cfg, e, i) for i, e in enumerate(wins)])


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("scheduler", ["greedy", "first_fit"])
def test_engine_on_card_matches_cpu(dev, scheduler, incremental):
    cfg = dataclasses.replace(REDUCED_SIM, max_nodes=12, max_tasks=128,
                              max_events_per_window=64, sched_batch=32,
                              incremental_accounting=incremental)
    ws = _soup(cfg)
    out = {}
    for d in (dev, torch.device("cpu")):
        state, rows = engine.run_windows(init_state(cfg, d),
                                         window_to_torch(ws, d), cfg,
                                         get_scheduler(scheduler))
        out[d.type] = (state_to_numpy(state),
                       {k: v.cpu().numpy() for k, v in rows.items()})
    (s_g, r_g), (s_c, r_c) = out["cuda"], out["cpu"]
    for k in s_c:
        np.testing.assert_array_equal(s_g[k], s_c[k], err_msg=k)
    for k in r_c:
        if k in ("util_balance_var", "reserved_balance_var"):
            np.testing.assert_allclose(r_g[k], r_c[k], rtol=2.5e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(r_g[k], r_c[k], err_msg=k)


@pytest.mark.parametrize("dispatch", ["auto", "switch"])
def test_fleet_on_card_matches_cpu(dev, dispatch):
    from repro_torch.scenarios import ScenarioSpec, build_knobs
    from repro_torch.scenarios import batch as batch_mod
    from repro_torch.sched import snapshot_dispatch
    cfg = dataclasses.replace(REDUCED_SIM, max_nodes=12, max_tasks=128,
                              max_events_per_window=64, sched_batch=32,
                              inject_slots=8, inject_task_slots=32,
                              sched_dispatch=dispatch)
    specs = [ScenarioSpec(name="g"),
             ScenarioSpec(name="ff", scheduler="first_fit"),
             ScenarioSpec(name="rr", scheduler="round_robin",
                          arrival_rate=2.0),
             ScenarioSpec(name="storm", evict_storm_frac=0.2,
                          node_outage_frac=0.2)]
    ws = _soup(cfg)
    out = {}
    for d in (dev, torch.device("cpu")):
        knobs, names = build_knobs(specs, d)
        state, rows = batch_mod.run_scenarios(
            batch_mod.init_batched_state(cfg, len(specs), d),
            window_to_torch(ws, d), knobs, cfg, names, 0, True,
            snapshot_dispatch(names),
            tuple(names.index(s.scheduler) for s in specs))
        out[d.type] = (state_to_numpy(state),
                       {k: v.cpu().numpy() for k, v in rows.items()})
    (s_g, r_g), (s_c, r_c) = out["cuda"], out["cpu"]
    for k in s_c:
        np.testing.assert_array_equal(s_g[k], s_c[k], err_msg=k)
    for k in r_c:
        if k in ("util_balance_var", "reserved_balance_var"):
            np.testing.assert_allclose(r_g[k], r_c[k], rtol=2.5e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(r_g[k], r_c[k], err_msg=k)


@pytest.mark.parametrize("B", [1, 8])
def test_segment_usage_surrogate_shape(dev, B):
    """E as the searches' surrogate calls it: each of P=1,024 tasks' (R=3)
    request into its argmax node of 12,500, masked by the task's weight;
    B=1 for SA and tabu, B=8 (one lane an individual) for the GA."""
    r = np.random.default_rng(23 + B)
    P, N, R = 1024, 12_500, 3
    choice = torch.from_numpy(r.integers(0, N, (B, P)).astype(np.int32))
    req = _g(r, 1, 48, (P, R))[None].expand(B, P, R)
    weight = torch.from_numpy(r.random(P) < 0.9)[None].expand(B, P)
    args = (choice, req, weight, N)
    n = su_ops.segment_usage_cuda.launches
    got = su_ops.segment_usage_lanes(*[x.to(dev) if torch.is_tensor(x)
                                       else x for x in args])
    assert su_ops.segment_usage_cuda.launches == n + 1
    want = segment_usage_lanes_ref(*args)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(24, 1000), (8, 24, 1000)],
                         ids=["one_key", "a_key_a_row"])
def test_key_draws_on_card_equal_cpu(dev, shape, monkeypatch):
    """split, uniform and randint on the card (the threefry kernel) give
    the CPU's bits, the CPU's drawn in many chunks of the flat index (the
    draws are counter-based, so small chunks show what cell A's shapes
    would; ``chip_smoke.py`` draws those)."""
    from repro_torch.core import prng
    from repro_torch.kernels.threefry import ref as threefry_ref
    monkeypatch.setattr(threefry_ref, "CHUNK", 4096)
    out = {}
    for d in (dev, torch.device("cpu")):
        k = prng.split(prng.key(7, d), 4)
        out[d.type] = (prng.split(k, 3), prng.uniform(k[1], shape),
                       prng.randint(k[2], 0, 12_500, shape[-2:]),
                       prng.uniform(k[3, None].expand(shape[0], 2),
                                    shape[1:]))
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g.dtype == c.dtype and torch.equal(g.cpu(), c)


@pytest.mark.parametrize("scheduler", ["random", "simulated_annealing",
                                       "tabu_search", "genetic"])
def test_stochastic_engine_on_card_matches_cpu(dev, scheduler):
    cfg = dataclasses.replace(REDUCED_SIM, max_nodes=12, max_tasks=128,
                              max_events_per_window=64, sched_batch=32)
    ws = _soup(cfg)
    out = {}
    for d in (dev, torch.device("cpu")):
        state, rows = engine.run_windows(init_state(cfg, d),
                                         window_to_torch(ws, d), cfg,
                                         get_scheduler(scheduler), 5)
        out[d.type] = (state_to_numpy(state),
                       {k: v.cpu().numpy() for k, v in rows.items()})
    (s_g, r_g), (s_c, r_c) = out["cuda"], out["cpu"]
    for k in s_c:
        np.testing.assert_array_equal(s_g[k], s_c[k], err_msg=k)
    for k in r_c:
        if k in ("util_balance_var", "reserved_balance_var"):
            np.testing.assert_allclose(r_g[k], r_c[k], rtol=2.5e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(r_g[k], r_c[k], err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,D", [(2, 128, 3, 32), (1, 200, 2, 64),
                                     (2, 256, 4, 128), (1, 77, 5, 128),
                                     (1, 1, 1, 16)])
def test_flash_attention(dev, B, S, H, D, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(B * S + H * D)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev,
                           dtype=dtype) for _ in range(3))
    before = fa_ops.flash_attention_cuda.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert fa_ops.flash_attention_cuda.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, err


def test_flash_attention_strided_inputs(dev):
    """q, k, v as views of one fused (B, S, 3, H, D) tensor and a
    head-major layout: the kernel reads them by strides."""
    g = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn((2, 130, 3, 4, 64), generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    vt = torch.randn((2, 4, 130, 64), generator=g, device=dev,
                     dtype=torch.bfloat16).transpose(1, 2)
    for vv in (v, vt):
        got = fa_ops.flash_attention(q, k, vv, causal=True, scale=0.11)
        want = attention_ref(q, k, vv, causal=True, scale=0.11)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,D", [(2, 128, 3, 64), (1, 200, 2, 96),
                                     (2, 256, 4, 128), (1, 77, 5, 128),
                                     (1, 1, 1, 64), (4, 512, 2, 128)])
def test_flash_attention_tensor_core_body(dev, B, S, H, D, causal):
    """bf16 with D in {64, 96, 128} goes through the tensor-core body (its
    own counter rises, once a call), within 2e-2 of the plain version."""
    g = torch.Generator(device=dev).manual_seed(B * S + H * D + causal)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    assert fa_ops.uses_tensor_cores(q.dtype, D)
    n, n_tc = (fa_ops.flash_attention_cuda.launches,
               fa_ops.flash_attention_cuda.launches_tc)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert fa_ops.flash_attention_cuda.launches == n + 1
    assert fa_ops.flash_attention_cuda.launches_tc == n_tc + 1
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2, err


@pytest.mark.parametrize("dtype,D,tc", [(torch.bfloat16, 48, True),
                                        (torch.bfloat16, 40, False),
                                        (torch.float32, 64, False)])
def test_flash_attention_body_by_dtype_and_head_dim(dev, dtype, D, tc):
    """The body depends on dtype and D alone: bf16 with D % 16 == 0 on
    tensor cores, bf16 with other D and f32 on the SIMT body."""
    g = torch.Generator(device=dev).manual_seed(D)
    q, k, v = (torch.randn((2, 150, 3, D), generator=g, device=dev,
                           dtype=dtype) for _ in range(3))
    n_tc = fa_ops.flash_attention_cuda.launches_tc
    got = fa_ops.flash_attention(q, k, v, causal=True)
    assert fa_ops.flash_attention_cuda.launches_tc == n_tc + int(tc)
    want = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_attention_refuses_misaligned_inputs(dev):
    """The tensor-core body's TMA needs 16-byte aligned bases and strides:
    a base 2 bytes off, or a head stride of 66 elements (132 bytes), is
    refused with ValueError and launches nothing."""
    buf = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=torch.bfloat16, device=dev)
    off = buf[1:].view(2, 64, 4, 64)
    wide = torch.zeros((2, 64, 4, 66), dtype=torch.bfloat16,
                       device=dev)[..., :64]
    ok = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16, device=dev)
    n = fa_ops.flash_attention_cuda.launches
    for bad in (off, wide):
        with pytest.raises(ValueError, match="16 bytes|16-byte"):
            fa_ops.flash_attention(ok, bad, ok)
    assert fa_ops.flash_attention_cuda.launches == n


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 8, 2, 160), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 32), device=dev)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError, match="unsupported dtype"):
        fa_ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 8, 2, 64), device=dev)[..., ::2]
        fa_ops.flash_attention(t, t, t)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_serving_on_card_matches_cpu(dev, impl):
    """qwen3-4b reduced to 2 layers (f32 activations, bf16 cache): the
    card's tokens equal the CPU path's, and the pallas impl launches kernel
    F once per layer of the prefill."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(reduced(get_config("qwen3-4b")), n_layers=2,
                              attention_impl=impl)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 130),
                         generator=torch.Generator().manual_seed(1))
    before = fa_ops.flash_attention_cuda.launches
    got = ServingEngine(cfg, _to(params, dev), 140).generate(toks.to(dev), 6)
    launched = fa_ops.flash_attention_cuda.launches - before
    assert launched == (cfg.n_layers if impl == "pallas" else 0)
    want = ServingEngine(cfg, params, 140).generate(toks, 6)
    assert torch.equal(got.cpu(), want), (got, want)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,Vp,V", [(1, 8, 64, 64), (100, 16, 128, 128),
                                      (200, 72, 1000, 900),
                                      (64, 32, 256, 250),
                                      (513, 256, 4096, 4000)])
def test_fused_ce(dev, T, d, Vp, V, dtype):
    g = torch.Generator(device=dev).manual_seed(T + d)
    x = torch.randn((T, d), generator=g, device=dev).to(dtype)
    w = torch.randn((Vp, d), generator=g, device=dev).to(dtype)
    lab = torch.randint(-1, V, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    before = ce_ops.fused_ce_cuda.launches
    nll, lse = ce_ops.fused_ce_with_lse(x, w, lab, V)
    assert ce_ops.fused_ce_cuda.launches == before + 1
    want_nll, want_lse = fused_ce_ref(x, w, lab, V)
    torch.cuda.synchronize()
    assert (nll - want_nll).abs().max() <= 1e-4
    assert (lse - want_lse).abs().max() <= 1e-4
    assert not nll[lab < 0].any()


@pytest.mark.parametrize("dtype,d,tc", [(torch.bfloat16, 64, True),
                                        (torch.bfloat16, 12, False),
                                        (torch.float32, 64, False)])
def test_fused_ce_body_by_dtype_and_shape(dev, dtype, d, tc):
    """bf16 with d % 8 == 0 goes through the tensor-core body (its own
    counter rises), f32 and bf16 with other d through the SIMT body; each
    within 1e-4 of the plain version."""
    T, Vp, V = 300, 1000, 990
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn((T, d), generator=g, device=dev).to(dtype)
    w = torch.randn((Vp, d), generator=g, device=dev).to(dtype)
    lab = torch.randint(-1, V, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    n, n_tc = ce_ops.fused_ce_cuda.launches, ce_ops.fused_ce_cuda.launches_tc
    nll, lse = ce_ops.fused_ce_with_lse(x, w, lab, V)
    assert ce_ops.fused_ce_cuda.launches == n + 1
    assert ce_ops.fused_ce_cuda.launches_tc == n_tc + int(tc)
    want_nll, want_lse = fused_ce_ref(x, w, lab, V)
    torch.cuda.synchronize()
    assert (nll - want_nll).abs().max() <= 1e-4
    assert (lse - want_lse).abs().max() <= 1e-4
    assert not nll[lab < 0].any()


def test_fused_ce_training_shape(dev):
    """qwen3-4b's training shape: T=2,048, d=2,560, Vp=152,064, V=151,936,
    bf16, a share of labels ignored."""
    T, d, Vp, V = 2048, 2560, 152064, 151936
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((T, d), generator=g, device=dev).bfloat16()
    w = (torch.randn((Vp, d), generator=g, device=dev) * 0.02).bfloat16()
    lab = torch.randint(0, V, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    lab[::7] = -1
    n_tc = ce_ops.fused_ce_cuda.launches_tc
    nll, lse = ce_ops.fused_ce_with_lse(x, w, lab, V)
    assert ce_ops.fused_ce_cuda.launches_tc == n_tc + 1
    want_nll, want_lse = fused_ce_ref(x, w, lab, V)
    torch.cuda.synchronize()
    assert (nll - want_nll).abs().max() <= 2e-3
    assert (lse - want_lse).abs().max() <= 2e-3
    assert not nll[lab < 0].any()


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_fused_ce_mean_grads_on_card(dev, dtype, rel):
    from repro_torch.models.model import cross_entropy_chunked_plain
    T, d, Vp, V = 300, 64, 1024, 1000
    g = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((T, d), generator=g, device=dev).to(dtype)
    w0 = torch.randn((Vp, d), generator=g, device=dev).to(dtype)
    lab = torch.randint(-1, V, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    out = []
    for fn in (lambda a, b: ce_ops.FusedCEMean.apply(a, b, lab, V, 4),
               lambda a, b: cross_entropy_chunked_plain(a, b, lab, V, 4)):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        loss = fn(x, w)
        loss.backward()
        out.append((loss.detach(), x.grad, w.grad))
    torch.cuda.synchronize()
    (lk, xk, wk), (lp, xp, wp) = out
    assert abs(float(lk) - float(lp)) <= 1e-4
    for a, b in ((xk, xp), (wk, wp)):
        assert a.dtype == dtype
        err = float((a.float() - b.float()).abs().max())
        assert err <= rel * max(float(b.float().abs().max()), 1e-30), err


def test_train_step_on_card_matches_cpu(dev):
    """qwen3-4b reduced to 2 layers, chunked CE (kernel G once a step), f32
    activations: two steps' losses within 1e-4 of the CPU path's."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model
    from repro_torch.train import optim
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(reduced(get_config("qwen3-4b")), n_layers=2,
                              chunked_ce=True, dtype="float32")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLM(cfg, 4, 32, seed=0)
    losses = {}
    for device in (dev, torch.device("cpu")):
        p = _to(model.init_params(cfg, torch.Generator().manual_seed(0)),
                device)
        st = optim.init_opt_state(p)
        fn = make_train_step(cfg, tc)
        before = ce_ops.fused_ce_cuda.launches
        out = []
        for s in range(2):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in data.global_batch(s).items()}
            p, st, m = fn(p, st, b)
            out.append(float(m["loss"]))
        assert ce_ops.fused_ce_cuda.launches - before == (
            2 if device.type == "cuda" else 0)
        losses[device.type] = out
    assert np.allclose(losses["cuda"], losses["cpu"], rtol=0, atol=1e-4)
