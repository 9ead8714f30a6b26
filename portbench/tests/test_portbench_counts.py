"""The frozen work counts of kernels A and D at cell A's shapes, against
counts worked out by hand, and the roofline bound."""
import pytest

import portbench_cells  # noqa: F401  (puts the checkout on sys.path)
from portbench.harness import roofline

# cell A: 64 lanes, 1,024 tasks a window's batch, 12,500 nodes, R=3, C=6, K=16
B, P, N, R, C, K = 64, 1024, 12500, 3, 6, 16


def test_match_work_at_cell_a():
    n_bytes, ops = roofline.match_work(B, P, N, R, C, K)
    # requests, constraints, two tallies, attributes, active flags
    per_lane_in = 12288 + 73728 + 300000 + 800000 + 12500
    per_lane_out = 1024 * 12500 * 4                          # the score matrix
    assert n_bytes == 64 * (per_lane_in + per_lane_out) == 3353505024
    assert ops == 64 * (37500 + 1024 * 12500 * 9) == 7375200000
    # bytes bound it: 3.35 GB at 3.35 TB/s is about a millisecond
    assert roofline.bound_s(n_bytes, ops) == pytest.approx(1.001e-3, rel=1e-3)


def test_commit_work_at_cell_a_grid():
    fams = ["scores"] * 16 + ["order"] * 32 + ["random"] * 16
    dyn = [True] * 16 + [False] * 48
    n_bytes, ops = roofline.commit_work(P, N, R, fams, dyn)
    ok = 64 * 1024 * 12500                 # feasibility, one byte a pair
    rand = 16 * 1024 * 12500 * 4           # the random lanes' preferences
    small = 64 * (12288 + 1024 + 450000 + 16)
    out = 64 * (4096 + 150000)
    assert n_bytes == ok + rand + small + out == 1677915136
    assert ops == 16 * 12800000 * 15 + 48 * 12800000 * 6 == 6758400000
    assert roofline.bound_s(n_bytes, ops) == pytest.approx(
        1677915136 / 3.35e12)


def test_static_best_fit_reads_the_scores():
    base = roofline.commit_work(P, N, R, ["scores"], [True])[0]
    static = roofline.commit_work(P, N, R, ["scores"], [False])[0]
    assert static - base == P * N * 4


def test_bound_takes_the_larger_term():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 134e12) == pytest.approx(2.0)
