"""The CUDA kernels against their plain versions, on the card, at shapes
that are not tile multiples and with more than one lane; and the engine on
the card against the CPU path. Skipped without a CUDA device; on the card
(where JAX, which tests/conftest.py imports, need not be installed):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Bar: integers exact, grid-data sums and scores bitwise, variances within
rtol 2.5e-7.
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
from repro_torch.kernels.constraint_match.ref import constraint_match_ref
from repro_torch.kernels.placement_commit import ops as pc_ops
from repro_torch.kernels.placement_commit.ref import placement_commit_ref
from repro_torch.kernels.segment_usage import ops as su_ops
from repro_torch.kernels.segment_usage.ref import segment_usage_ref
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


@pytest.mark.parametrize("P,N", [(1, 1), (7, 129), (130, 300)])
def test_constraint_match(dev, P, N):
    r = np.random.default_rng(P + N)
    C, K = 6, 16
    cons = torch.from_numpy(np.stack(
        [r.integers(-2, K + 2, (P, C)), r.integers(0, 6, (P, C)),
         r.integers(0, 4, (P, C))], -1).astype(np.int32))
    args = [x.to(dev) for x in (
        _g(r, 1, 48, (P, 3)), cons, _g(r, 16, 256, (N, 3)),
        _g(r, 0, 160, (N, 3)),
        torch.from_numpy(r.integers(0, 4, (N, K)).astype(np.int32)),
        torch.from_numpy(r.random(N) < 0.8))]
    before = cm_ops.constraint_match_cuda.launches
    got = cm_ops.constraint_match(*args)
    assert cm_ops.constraint_match_cuda.launches == before + 1
    want = constraint_match_ref(*args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
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
    node_of, tally = pc_ops.placement_commit_cuda(*ops, mode)
    for b in range(B):
        want_n, want_t = placement_commit_ref(*[x[b] for x in ops],
                                              mode == "dynamic")
        assert torch.equal(node_of[b], want_n)
        assert torch.equal(tally[b], want_t)


@pytest.mark.parametrize("B,T,N", [(1, 1000, 77), (2, 5000, 1100)])
def test_window_stats_lanes(dev, B, T, N):
    r = np.random.default_rng(T + N)
    ins = [torch.from_numpy(r.integers(0, 3, (B, T)).astype(np.int8)),
           _g(r, 0, 32, (B, T, 8)),
           torch.from_numpy(r.integers(-2, 14, (B, T)).astype(np.int32)),
           torch.from_numpy(r.random((B, N)) < 0.8),
           _g(r, 16, 256, (B, N, 3)), _g(r, 0, 128, (B, N, 3)),
           _g(r, 0, 64, (B, N, 3))]
    ins = [x.to(dev) for x in ins]
    counts, by_prio, usum, node_red = ws_ops.window_stats_cuda(*ins)
    for b in range(B):
        w = window_reductions_ref(*[x[b] for x in ins])
        assert counts[b].tolist() == [int(w.n_running), int(w.n_pending),
                                      int(w.n_nodes)]
        assert torch.equal(by_prio[b], w.by_prio)
        assert torch.equal(usum[b], w.usage_sum)
        assert torch.equal(node_red[b, :9],
                           torch.cat([w.cap, w.reserved, w.used]))
        torch.testing.assert_close(
            node_red[b, 9:], torch.stack([w.util_var, w.res_var]),
            rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("T,N,V", [(5000, 1000, 3), (300, 65, 1),
                                   (2048, 10, 8)])
def test_segment_usage(dev, T, N, V):
    r = np.random.default_rng(T + N + V)
    node = torch.from_numpy(r.integers(-1, N, T).astype(np.int32)).to(dev)
    vals = _g(r, 0, 48, (T, V)).to(dev)
    mask = torch.from_numpy(r.random(T) < 0.6).to(dev)
    assert torch.equal(su_ops.segment_usage(node, vals, mask, N),
                       segment_usage_ref(node, vals, mask, N))


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
