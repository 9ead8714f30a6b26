"""The port's segment-usage plain version against the reference's jnp
oracle and Pallas kernel (interpret mode): masks, unplaced (-1) rows, an
all-masked table; grid data bitwise, off-grid data to rtol 1e-6."""
import numpy as np
import pytest
import torch

from repro.kernels.segment_usage.ops import segment_usage as su_jax
from repro.kernels.segment_usage.ref import segment_usage_ref
from repro_torch.kernels.segment_usage import ops as su_ops

torch.set_num_threads(1)


def _inputs(seed, T, N, V=3, p_mask=0.7, on_grid=True):
    r = np.random.default_rng(seed)
    node = r.integers(-1, N, T).astype(np.int32)
    vals = ((r.integers(0, 48, (T, V)) / 128) if on_grid
            else r.random((T, V))).astype(np.float32)
    return node, vals, r.random(T) < p_mask


def _port(node, vals, mask, N):
    return su_ops.segment_usage(torch.from_numpy(node),
                                torch.from_numpy(vals),
                                torch.from_numpy(mask), N).numpy()


@pytest.mark.parametrize("T,N,p_mask", [(96, 16, 0.7), (1000, 37, 0.5),
                                        (96, 16, 1.0)])
def test_plain_matches_reference_ref_and_kernel(T, N, p_mask):
    node, vals, mask = _inputs(T + N, T, N, p_mask=p_mask)
    got = _port(node, vals, mask, N)
    np.testing.assert_array_equal(
        got, np.asarray(segment_usage_ref(node, vals, mask, N)))
    np.testing.assert_array_equal(
        got, np.asarray(su_jax(node, vals, mask, N, use_kernel=True,
                               interpret=True, tile_t=256)))


def test_everything_masked_gives_zeros():
    node, vals, _ = _inputs(1, 64, 8)
    mask = np.zeros(64, bool)
    got = _port(node, vals, mask, 8)
    np.testing.assert_array_equal(got, np.zeros((8, 3), np.float32))
    np.testing.assert_array_equal(
        got, np.asarray(segment_usage_ref(node, vals, mask, 8)))


def test_unplaced_rows_are_dropped():
    node, vals, mask = _inputs(2, 64, 8, p_mask=1.0)
    node[:] = -1
    assert not _port(node, vals, mask, 8).any()


def test_off_grid_values():
    node, vals, mask = _inputs(5, 2000, 50, on_grid=False)
    np.testing.assert_allclose(
        _port(node, vals, mask, 50),
        np.asarray(segment_usage_ref(node, vals, mask, 50)), rtol=1e-6)
