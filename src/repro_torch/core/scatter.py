"""Row scatters with the reference's ``mode="drop"`` semantics, without a
host sync and without order-dependent results.

The reference routes masked-out event rows to an out-of-range index that
the scatter drops. Here:

* :func:`set_rows_` writes in place. Every row computes the value its
  target slot ends with (the value of the LAST unmasked row aimed at it,
  as the reference's sequential scatter leaves it, else the slot's current
  value), so rows that share a slot all write the same value and the
  result does not depend on which write lands last.
* :func:`add_rows` accumulates into a copy with overflow rows that masked
  rows go to and that are sliced off. ``index_put_`` with
  ``accumulate=True`` adds duplicate indices deterministically on both
  devices (the CUDA implementation sorts the indices and sums each run in
  row order; no float atomics), so several events or placements on one
  node give the same bits on every run.

Masked rows go to overflow slots of their own (one per event row), not to
one shared slot: on the card a run of thousands of equal indices would be
summed (or max-reduced) one after another by a single thread.
"""
from __future__ import annotations

import torch


def set_rows_(dst: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
              vals) -> None:
    """``dst[rows[e]] = vals[e]`` for every row ``e`` with ``mask[e]`` and
    ``0 <= rows[e] < len(dst)``, last row winning; others are dropped.
    ``vals`` is a tensor with one entry per row, or a Python scalar."""
    n, E = dst.shape[0], rows.shape[0]
    rows = rows.long()
    ok = mask & (rows >= 0) & (rows < n)
    order = torch.arange(E, device=dst.device)
    last = torch.full((n + E,), -1, dtype=torch.long, device=dst.device)
    last.scatter_reduce_(0, torch.where(ok, rows, n + order), order, "amax")
    r = rows.clamp(0, n - 1)
    win = last[r]                               # winning row of r's target
    old = dst[r]
    have = (win >= 0).view((E,) + (1,) * (old.dim() - 1))
    if isinstance(vals, torch.Tensor):
        vals = vals[win.clamp_min(0)].to(dst.dtype)
    dst[r] = torch.where(have, vals, old)


def add_rows(acc: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``acc (N, R)`` plus ``vals (E, R)`` at ``rows`` where ``mask``;
    other rows are dropped. Returns a new tensor."""
    n, E = acc.shape[0], rows.shape[0]
    rows = rows.long()
    ok = mask & (rows >= 0) & (rows < n)
    buf = torch.cat([acc, acc.new_zeros((E,) + tuple(acc.shape[1:]))])
    overflow = n + torch.arange(E, device=acc.device)
    buf.index_put_((torch.where(ok, rows, overflow),),
                   torch.where(mask[:, None], vals, 0.0), accumulate=True)
    return buf[:n]
