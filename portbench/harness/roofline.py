"""The yardstick for kernel shares: the H100's published peaks and the
work each kernel's call needs, counted from the op's contract at the
call's shapes, never from its launch configuration.

Each input byte is counted as read once and each output byte as written
once; the float operations are those the contract's arithmetic needs per
(task, node) pair. So a later kernel that fuses, splits or replaces one of
these calls is held to the same work.
"""
from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the work can take: the larger of its bytes at the
    HBM rate and its float32 operations at the SIMT rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def match_work(B: int, P: int, N: int, R: int, C: int, K: int
               ) -> Tuple[float, float]:
    """Kernel A (``constraint_match``), one launch over B lanes: (bytes,
    float ops). Reads each lane's P requests (R f32), P constraint rows
    (C x 3 i32), node capacity and reservation (N x R f32 each), attributes
    (N x K i32) and the active flags (N bytes); writes the (P, N) f32
    scores. Per node R subtractions give the free capacity; per pair R
    subtractions, R divisions and R additions give the best-fit score."""
    read = B * (P * R * 4 + P * C * 3 * 4 + 2 * N * R * 4 + N * K * 4 + N)
    write = B * P * N * 4
    ops = B * (N * R + P * N * 3 * R)
    return float(read + write), float(ops)


def commit_work(P: int, N: int, R: int, families: Sequence[str],
                dynamic: Sequence[bool]) -> Tuple[float, float]:
    """Kernel D (``sched_commit``), one launch over the lanes of
    ``families`` ('scores', 'order' or 'random' a lane) and their dynamic
    best-fit flags: (bytes, float ops). Reads each lane's (P, N)
    feasibility (bool), the (P, N) f32 preference of a random lane (the
    shared scores only for a static best-fit lane; node-order and dynamic
    lanes derive theirs), requests (P x R f32), valid flags (P), capacity,
    normaliser and starting tally (N x R f32 each) and four i32 lane
    parameters; writes the (P,) node choices (i32) and the final (N, R)
    tally. Per pair a static lane needs R subtractions and R additions (the
    fit test against the running tally), a dynamic one 3R more (the
    re-scored best fit)."""
    B = len(families)
    pref = sum(1 for f, d in zip(families, dynamic)
               if f == "random" or (f == "scores" and not d))
    read = (B * P * N + pref * P * N * 4
            + B * (P * R * 4 + P + 3 * N * R * 4 + 4 * 4))
    write = B * (P * 4 + N * R * 4)
    ops = sum(P * N * (5 * R if d else 2 * R) for d in dynamic)
    return float(read + write), float(ops)
