"""The port's fused window-stats reductions and composed stats rows against
the reference's (jnp fused ref, Pallas kernel in interpret mode, unfused
body) on the same numpy state.

Bar: integers exact, sums bitwise on grid data (multiples of 1/128), the
two variances and the ratio fields within rtol 2.5e-7 (about 2 ulp; the
reference's own kernel and ref differ by 1 ulp in ``res_var``); off the
grid, floats within rtol 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import REDUCED_SIM as REF_REDUCED
from repro.core import stats as ref_stats
from repro.core.state import init_state as ref_init_state
from repro.kernels.window_stats.ops import window_reductions as wr_jax
from repro_torch.config import REDUCED_SIM
from repro_torch.core import stats as port_stats
from repro_torch.core.state import state_from_numpy
from repro_torch.kernels.window_stats.ops import window_reductions

torch.set_num_threads(1)

VARIANCES = ("util_var", "res_var", "util_balance_var",
             "reserved_balance_var")


def _state(seed, T=96, N=16, on_grid=True):
    cfg_ref = dataclasses.replace(REF_REDUCED, max_nodes=N, max_tasks=T)
    r = np.random.default_rng(seed)
    g = ((lambda lo, hi, sh: (r.integers(lo, hi, sh) / 128))
         if on_grid else (lambda lo, hi, sh: r.uniform(lo, hi, sh) / 128))
    s = {k: np.asarray(v) for k, v in ref_init_state(cfg_ref)._asdict()
         .items()}
    s["task_state"] = r.integers(0, 3, T).astype(np.int8)
    s["task_usage"] = g(0, 32, (T, 8)).astype(np.float32)
    s["task_prio"] = r.integers(-2, 14, T).astype(np.int32)
    s["node_active"] = r.random(N) < 0.8
    s["node_total"] = g(16, 256, (N, 3)).astype(np.float32)
    s["node_reserved"] = g(0, 128, (N, 3)).astype(np.float32)
    s["node_used"] = g(0, 64, (N, 3)).astype(np.float32)
    s["evictions"] = np.asarray(3, np.int32)
    return s, cfg_ref


ULP_RTOL = 2.5e-7


def _assert_close(name, got, want, on_grid=True):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif name in VARIANCES or (on_grid and name.endswith(("_frac",
                                                          "usage_mean"))):
        np.testing.assert_allclose(got, want, rtol=ULP_RTOL, atol=0,
                                   err_msg=name)
    elif on_grid:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


def _red_args(s, to):
    keys = ("task_state", "task_usage", "task_prio", "node_active",
            "node_total", "node_reserved", "node_used")
    return [to(s[k]) for k in keys]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reductions_match_reference_ref_and_kernel(seed):
    s, _ = _state(seed)
    got = window_reductions(*_red_args(s, torch.from_numpy))
    want = wr_jax(*_red_args(s, jnp.asarray))
    kern = wr_jax(*_red_args(s, jnp.asarray), use_kernel=True,
                  interpret=True)
    for f in got._fields:
        _assert_close(f, getattr(got, f).numpy(), getattr(want, f))
        _assert_close(f, getattr(got, f).numpy(), getattr(kern, f))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("on_grid", [True, False])
def test_stats_rows_match_reference(fused, on_grid):
    s, cfg_ref = _state(7, on_grid=on_grid)
    cfg_ref = dataclasses.replace(cfg_ref, fused_window_stats=fused)
    cfg = dataclasses.replace(REDUCED_SIM, max_nodes=cfg_ref.max_nodes,
                              max_tasks=cfg_ref.max_tasks,
                              fused_window_stats=fused)
    ref_state = type(ref_init_state(cfg_ref))(
        **{k: jnp.asarray(v) for k, v in s.items()})
    want = ref_stats.window_stats(ref_state, cfg_ref)
    # the port reads no fused_window_stats: its unfused body is called
    # directly, as the oracle it is
    row = port_stats.window_stats if fused else port_stats.window_stats_ref
    got = row(state_from_numpy(s, "cpu"), cfg)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        _assert_close(k, got[k].numpy(), want[k], on_grid)


def test_fused_and_unfused_rows_agree():
    s, _ = _state(3)
    st = state_from_numpy(s, "cpu")
    fused = port_stats.window_stats(st, REDUCED_SIM)
    unfused = port_stats.window_stats_ref(st, REDUCED_SIM)
    for k in fused:
        _assert_close(k, fused[k].numpy(), unfused[k].numpy())


def test_reductions_match_reference_at_cell_a_width():
    """Cell A's table: T=262,144 task slots (U=8), N=12,500 nodes, R=3, on
    grid data: counts, histogram and sums bitwise, the variances within
    rtol 2.5e-7 of the reference's jnp oracle."""
    T, N, U, R = 262144, 12500, 8, 3
    r = np.random.default_rng(17)

    def g(lo, hi, shape):
        return (r.integers(lo, hi, shape) / 128).astype(np.float32)

    s = {"task_state": r.integers(0, 3, T).astype(np.int8),
         "task_usage": g(0, 16, (T, U)),
         "task_prio": r.integers(-1, 13, T).astype(np.int32),
         "node_active": r.random(N) < 0.95,
         "node_total": g(64, 256, (N, R)), "node_reserved": g(0, 64, (N, R)),
         "node_used": g(0, 64, (N, R))}
    got = window_reductions(*_red_args(s, torch.from_numpy))
    want = wr_jax(*_red_args(s, jnp.asarray))
    for f in got._fields:
        _assert_close(f, getattr(got, f).numpy(), getattr(want, f))
    assert int(got.n_running) > 0 and int(got.n_pending) > 0


def test_window_stats_ignores_fused_flag():
    """Like use_kernels, fused_window_stats is kept for config equality
    only: the row is the fused one whatever the flag says."""
    st = state_from_numpy(_state(4)[0], "cpu")
    on = port_stats.window_stats(st, REDUCED_SIM)
    off = port_stats.window_stats(
        st, dataclasses.replace(REDUCED_SIM, fused_window_stats=False))
    for k in on:
        assert torch.equal(on[k], off[k]), k
