"""The port's commit scan (plain version) against the reference's
``placement_commit_ref`` and its Pallas kernel (interpret mode), static and
dynamic modes: node_of exact, the final tally bitwise on grid data. Plus
the all-infeasible row and ``pending_batch``'s tie order against
``jax.lax.top_k``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import REDUCED_SIM as REF_REDUCED
from repro.core.state import init_state as ref_init_state
from repro.kernels.placement_commit.ops import placement_commit as pc_jax
from repro.kernels.placement_commit.ref import placement_commit_ref as ref_pc
from repro.sched.base import base_pass as ref_base_pass
from repro_torch.config import REDUCED_SIM
from repro_torch.core.state import state_from_numpy
from repro_torch.kernels.placement_commit import ops as pc_ops
from repro_torch.sched.base import base_pass, pending_batch

torch.set_num_threads(1)


def _inputs(seed, P, N, R=3):
    r = np.random.default_rng(seed)
    g = lambda lo, hi, shape: (r.integers(lo, hi, shape) / 128).astype(
        np.float32)
    total = g(16, 256, (N, R))
    active = r.random(N) > 0.2
    total_f = np.where(active[:, None], total, -1.0).astype(np.float32)
    denom = np.maximum(total, 1e-6).astype(np.float32)
    pref = g(-256, 0, (P, N))
    ok = r.random((P, N)) < 0.7
    return (pref, g(1, 64, (P, R)), ok, r.random(P) < 0.85, total_f, denom,
            g(0, 96, (N, R)))


def _port(args, dynamic):
    node_of, tally = pc_ops.placement_commit(
        *[torch.from_numpy(a) for a in args], dynamic, return_tally=True)
    return node_of.numpy(), tally.numpy()


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("P,N", [(24, 16), (40, 33)])
def test_plain_matches_reference_ref_and_kernel(P, N, dynamic):
    args = _inputs(P + N + dynamic, P, N)
    node_of, tally = _port(args, dynamic)
    want_n, want_t = ref_pc(*map(jnp.asarray, args), dynamic_bestfit=dynamic)
    np.testing.assert_array_equal(node_of, np.asarray(want_n))
    np.testing.assert_array_equal(tally, np.asarray(want_t))
    k_n, k_t = pc_jax(*map(jnp.asarray, args), dynamic, use_kernel=True, interpret=True,
                      return_tally=True)
    np.testing.assert_array_equal(node_of, np.asarray(k_n))
    np.testing.assert_array_equal(tally, np.asarray(k_t))
    assert (node_of >= 0).any() and (node_of == -1).any()


@pytest.mark.parametrize("dynamic", [False, True])
def test_all_infeasible_row_picks_node_zero_and_places_nothing(dynamic):
    args = list(_inputs(3, 8, 12))
    args[2] = args[2].copy()
    args[2][0] = False                   # row 0: no node is feasible
    node_of, tally = _port(args, dynamic)
    assert node_of[0] == -1
    want_n, want_t = ref_pc(*map(jnp.asarray, args), dynamic_bestfit=dynamic)
    np.testing.assert_array_equal(node_of, np.asarray(want_n))
    np.testing.assert_array_equal(tally, np.asarray(want_t))


def test_traced_flag_is_refused():
    args = [torch.from_numpy(a) for a in _inputs(1, 4, 4)]
    with pytest.raises(TypeError, match="scenario fleet"):
        pc_ops.placement_commit(*args, torch.tensor(True))
    with pytest.raises(ValueError, match="both"):
        pc_ops.placement_commit_cuda(*[a[None] for a in args], "both")


def _tied_state(seed, cfg_ref):
    """A reference state whose pending slots share few priorities."""
    r = np.random.default_rng(seed)
    s = {k: np.asarray(v) for k, v in ref_init_state(cfg_ref)._asdict()
         .items()}
    T, N = cfg_ref.max_tasks, cfg_ref.max_nodes
    s["task_state"] = r.integers(0, 3, T).astype(np.int8)
    s["task_prio"] = r.choice([0, 4, 9], T).astype(np.int32)
    s["task_req"] = (r.integers(1, 32, (T, 3)) / 128).astype(np.float32)
    s["node_active"] = r.random(N) < 0.9
    s["node_total"] = (r.integers(32, 256, (N, 3)) / 128).astype(np.float32)
    s["node_attrs"] = r.integers(0, 3, (N, cfg_ref.n_attr_slots)
                                 ).astype(np.int32)
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pending_batch_tie_order_matches_top_k(seed):
    cfg_ref = dataclasses.replace(REF_REDUCED, max_nodes=16, max_tasks=96,
                                  sched_batch=24)
    cfg = dataclasses.replace(REDUCED_SIM, max_nodes=16, max_tasks=96,
                              sched_batch=24)
    s = _tied_state(seed, cfg_ref)
    idx, valid = pending_batch(state_from_numpy(s, "cpu"), cfg)
    pend = s["task_state"] == 1
    key = np.where(pend, s["task_prio"], np.iinfo(np.int32).min)
    _, want = jax.lax.top_k(jnp.asarray(key), cfg.sched_batch)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(valid.numpy(), pend[np.asarray(want)])

    ref_state = type(ref_init_state(cfg_ref))(
        **{k: jnp.asarray(v) for k, v in s.items()})
    r_idx, r_valid, r_ok, r_scores = ref_base_pass(ref_state, cfg_ref)
    p_idx, p_valid, p_ok, p_scores = base_pass(state_from_numpy(s, "cpu"),
                                               cfg)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(p_ok.numpy(), np.asarray(r_ok))
    np.testing.assert_array_equal(p_scores.numpy(), np.asarray(r_scores))
