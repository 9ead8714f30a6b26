"""The port's segment-usage plain version against the reference's jnp
oracle and Pallas kernel (interpret mode): masks, unplaced (-1) rows, an
all-masked table, 70,000 nodes with 12 value columns (past the kernel's
old ceilings); grid data bitwise, off-grid data to rtol 1e-6. Plus the
kernel's digit-pass count and scratch size."""
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


def _lane_inputs(seed, B, T, N, V, kind):
    """Grid data for B lanes: uniform nodes (some -1), every task on one
    node, a Zipf draw over the nodes, or an empty mask."""
    r = np.random.default_rng(seed)
    if kind == "one_node":
        node = np.full((B, T), N // 2, np.int32)
    elif kind == "zipf":
        node = np.minimum(r.zipf(1.5, (B, T)) - 1, N - 1).astype(np.int32)
    else:
        node = r.integers(-1, N, (B, T)).astype(np.int32)
    vals = (r.integers(0, 48, (B, T, V)) / 128).astype(np.float32)
    mask = (np.zeros((B, T), bool) if kind == "empty"
            else r.random((B, T)) < 0.7)
    return node, vals, mask


@pytest.mark.parametrize("kind", ["uniform", "one_node", "zipf", "empty"])
@pytest.mark.parametrize("B,T,N,V", [(1, 96, 16, 3), (3, 100, 13, 6),
                                     (4, 70, 9, 1), (2, 64, 16, 8)])
def test_lanes_plain_matches_vmapped_reference(B, T, N, V, kind):
    """The lane form of the plain version against jax.vmap of the
    reference's segment_usage: its jnp oracle and its Pallas kernel in
    interpret mode; grid data, so every order of the sums is exact."""
    import jax
    node, vals, mask = _lane_inputs(B * T + N + V, B, T, N, V, kind)
    got = su_ops.segment_usage_lanes(torch.from_numpy(node),
                                     torch.from_numpy(vals),
                                     torch.from_numpy(mask), N).numpy()
    assert got.shape == (B, N, V) and got.dtype == np.float32
    want_ref = jax.vmap(lambda n, v, m: segment_usage_ref(n, v, m, N))(
        node, vals, mask)
    want_kernel = jax.vmap(lambda n, v, m: su_jax(
        n, v, m, N, use_kernel=True, interpret=True, tile_t=32))(
            node, vals, mask)
    np.testing.assert_array_equal(got, np.asarray(want_ref))
    np.testing.assert_array_equal(got, np.asarray(want_kernel))
    if kind == "empty":
        assert not got.any()


def test_lanes_are_independent_and_single_lane_form_agrees():
    """Lane b of the lane form equals the single-lane form on lane b's
    inputs, off-grid data included (bitwise: the same sums in the same
    order)."""
    r = np.random.default_rng(7)
    B, T, N, V = 3, 500, 20, 6
    node = torch.from_numpy(r.integers(-1, N, (B, T)).astype(np.int32))
    vals = torch.from_numpy(r.random((B, T, V)).astype(np.float32))
    mask = torch.from_numpy(r.random((B, T)) < 0.6)
    got = su_ops.segment_usage_lanes(node, vals, mask, N)
    for b in range(B):
        assert torch.equal(got[b],
                           su_ops.segment_usage(node[b], vals[b], mask[b], N))


@pytest.mark.parametrize("B,T,n_nodes", [(1, 1, 1), (1, 262144, 12500),
                                         (8, 262144, 12500),
                                         (3, 1025, 70000)])
def test_kernel_scratch_size(B, T, n_nodes):
    """The wrapper's scratch: per-tile digit counts, each digit pass's
    totals, the kept counts, two (B, T) permutations and the sorted node
    ids, as csrc/segment_usage.cu lays them out (cell A: two passes)."""
    tiles = -(-T // su_ops.TILE)
    passes = su_ops.digit_passes(n_nodes)
    assert passes == {1: 1, 12500: 2, 70000: 3}[n_nodes]
    assert su_ops.scratch_ints(B, T, passes) == B * (
        su_ops.RADIX * tiles + passes * su_ops.RADIX + 1 + 3 * T)


def test_digit_passes_cover_every_node_id():
    """For every N from 1 to 250,000 the passes never refuse and sort
    each id 0..N-1 once: the 7-bit digits of N - 1, the largest id, fit
    (so every id's do, and the LSD passes order them all), and one pass
    fewer would drop the top digit of some id (the count is the least);
    any int32 id takes at most 5 passes."""
    n = np.arange(1, 250_001, dtype=np.int64)
    passes = np.array([su_ops.digit_passes(int(x)) for x in n])
    bits = su_ops.DIGIT_BITS
    assert passes.min() == 1 and passes.max() == 3
    assert np.all((n - 1) >> (bits * passes) == 0)
    more = passes > 1
    assert np.all((n[more] - 1) >> (bits * (passes[more] - 1)) != 0)
    assert su_ops.digit_passes(2 ** 31 - 1) == 5


def test_many_nodes_and_columns_match_reference():
    """70,000 nodes (three 7-bit digit passes on the card) and V=12 (two
    column groups there): the lane form against jax.vmap of the
    reference's jnp oracle, grid data bitwise."""
    import jax
    B, T, N, V = 2, 6000, 70000, 12
    r = np.random.default_rng(70)
    node = np.where(r.random((B, T)) < 0.5, r.integers(-1, N, (B, T)),
                    N - 1 - r.integers(0, 40, (B, T))).astype(np.int32)
    vals = (r.integers(0, 48, (B, T, V)) / 128).astype(np.float32)
    mask = r.random((B, T)) < 0.7
    got = su_ops.segment_usage_lanes(torch.from_numpy(node),
                                     torch.from_numpy(vals),
                                     torch.from_numpy(mask), N).numpy()
    want = jax.vmap(lambda n, v, m: segment_usage_ref(n, v, m, N))(
        node, vals, mask)
    assert got.shape == (B, N, V)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[:, N - 40:].any()


def test_cuda_wrapper_refuses_cpu_tensors():
    node, vals, mask = _lane_inputs(0, 1, 8, 4, 3, "uniform")
    with pytest.raises(ValueError):
        su_ops.segment_usage_cuda(torch.from_numpy(node),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(mask), 4)
