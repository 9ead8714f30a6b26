"""The port's constraint-match plain version against the reference's jnp
oracle and its Pallas kernel (interpret mode), on the same numpy inputs.

Grid-aligned inputs (multiples of 1/128) are held bitwise; off-grid inputs
to rtol 1e-6 with the feasibility mask exact. The CUDA kernel itself is
compared with this plain version on the card (chip_smoke.py and
tests/test_torch_kernels_cuda.py) at cell A's width, so this plain version
is held to the reference's jnp oracle there too.
"""
import numpy as np
import pytest
import torch

from repro.kernels.constraint_match.ops import constraint_match as cm_jax
from repro.kernels.constraint_match.ref import constraint_match_ref
from repro_torch.core.events import OP_EQ, OP_GT, OP_LT, OP_NE, OP_NONE
from repro_torch.kernels.constraint_match import ops as cm_ops

torch.set_num_threads(1)


def _inputs(seed, P, N, R=3, C=4, K=8, dead=0.2, on_grid=True, op=None):
    r = np.random.default_rng(seed)

    def res(lo, hi, shape):
        if on_grid:
            return (r.integers(lo, hi, shape) / 128).astype(np.float32)
        return r.uniform(lo / 128, hi / 128, shape).astype(np.float32)

    ops = (r.integers(0, 5, (P, C)) if op is None
           else np.where(r.random((P, C)) < 0.5, op, OP_NONE))
    cons = np.stack([r.integers(0, K, (P, C)), ops, r.integers(0, 4, (P, C))],
                    axis=-1).astype(np.int32)
    return (res(1, 48, (P, R)), cons, res(16, 256, (N, R)),
            res(0, 160, (N, R)), r.integers(0, 4, (N, K)).astype(np.int32),
            r.random(N) > dead)


def _port(args):
    return cm_ops.constraint_match(*[torch.from_numpy(a) for a in args]
                                   ).numpy()


@pytest.mark.parametrize("P,N", [(24, 16), (37, 129), (128, 128)])
def test_plain_matches_reference_ref_and_kernel(P, N):
    args = _inputs(P * 1000 + N, P, N)
    got = _port(args)
    want = np.asarray(constraint_match_ref(*args))
    np.testing.assert_array_equal(got, want)
    kern = np.asarray(cm_jax(*args, use_kernel=True, interpret=True))
    np.testing.assert_array_equal(got, kern)
    assert np.isfinite(got).any() and np.isinf(got).any()


@pytest.mark.parametrize("op", [OP_EQ, OP_NE, OP_LT, OP_GT])
def test_every_constraint_op(op):
    args = _inputs(op, 24, 16, op=op)
    np.testing.assert_array_equal(_port(args),
                                  np.asarray(constraint_match_ref(*args)))


def test_dead_nodes_are_never_feasible():
    args = _inputs(7, 24, 16, dead=0.5)
    got = _port(args)
    assert np.isneginf(got[:, ~args[5]]).all()
    np.testing.assert_array_equal(got, np.asarray(constraint_match_ref(*args)))


def test_off_grid_inputs():
    """Off the grid the terms are no longer exact: scores within rtol 1e-6,
    the feasibility decision exact."""
    args = _inputs(11, 48, 40, on_grid=False)
    got, want = _port(args), np.asarray(constraint_match_ref(*args))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


@pytest.mark.slow       # ~6 s on one CPU thread: 12.8 M pairs, twice
def test_plain_matches_reference_at_cell_a_width():
    """Cell A's scheduling pass: P=1,024 tasks x N=12,500 nodes, R=3, C=6,
    K=16 (chip_smoke.py's inputs), bitwise against the jnp oracle."""
    P, N, R, C, K = 1024, 12500, 3, 6, 16
    r = np.random.default_rng(17)

    def g(lo, hi, shape):
        return (r.integers(lo, hi, shape) / 128).astype(np.float32)

    cons = np.stack([r.integers(0, K, (P, C)),
                     np.where(r.random((P, C)) < 0.8, 0,
                              r.integers(1, 5, (P, C))),
                     r.integers(0, 4, (P, C))], axis=-1).astype(np.int32)
    args = (g(1, 48, (P, R)), cons, g(64, 256, (N, R)), g(0, 64, (N, R)),
            r.integers(0, 4, (N, K)).astype(np.int32), r.random(N) < 0.95)
    got = _port(args)
    np.testing.assert_array_equal(got, np.asarray(constraint_match_ref(*args)))
    assert np.isfinite(got).any() and np.isinf(got).any()


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches only on CUDA tensors; the CPU path goes
    through the plain version by dispatch, never by a fallback."""
    args = [torch.from_numpy(a)[None] for a in _inputs(3, 8, 8)]  # one lane
    with pytest.raises(ValueError, match="CUDA"):
        cm_ops.constraint_match_cuda(*args)
    assert cm_ops.constraint_match_cuda.launches == 0
