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

Both take a lane axis: with ``rows`` of shape (B, E) the table is (B, n,
...) and lane b's rows address lane b's table only. The scatter then runs
once over the flattened (B*n, ...) table, each lane's slots offset by
``b*n`` (a row outside [0, n) is dropped, never carried into a
neighbouring lane), so one launch serves every lane and each lane's rows
keep their order.
"""
from __future__ import annotations

import torch


def lane_flat(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(B, E) per-lane rows -> (B*E,) rows of the flattened (B*n) table;
    rows outside [0, n) become -1 (dropped)."""
    rows = rows.long()
    off = torch.arange(rows.shape[0], device=rows.device)[:, None] * n
    return torch.where((rows >= 0) & (rows < n), rows + off, -1).reshape(-1)


def set_rows_(dst: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
              vals) -> None:
    """``dst[rows[e]] = vals[e]`` for every row ``e`` with ``mask[e]`` and
    ``0 <= rows[e] < len(dst)``, last row winning; others are dropped.
    ``vals`` is a tensor with one entry per row, or a Python scalar. With
    (B, E) ``rows`` and ``mask``, ``dst`` is (B, n, ...) and ``vals`` (B,
    E, ...) or a scalar."""
    if rows.dim() == 2:
        B, n = dst.shape[0], dst.shape[1]
        if B == 1:
            set_rows_(dst[0], rows[0], mask[0],
                      vals[0] if isinstance(vals, torch.Tensor) else vals)
            return
        if isinstance(vals, torch.Tensor):
            vals = vals.reshape((-1,) + tuple(vals.shape[2:]))
        set_rows_(dst.view((B * n,) + tuple(dst.shape[2:])),
                  lane_flat(rows, n), mask.reshape(-1), vals)
        return
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
    other rows are dropped. Returns a new tensor. With (B, E) ``rows`` and
    ``mask``: ``acc`` (B, N, R) and ``vals`` (B, E, R)."""
    if rows.dim() == 2:
        B, n = acc.shape[0], acc.shape[1]
        if B == 1:
            return add_rows(acc[0], rows[0], mask[0], vals[0])[None]
        out = add_rows(acc.reshape((B * n,) + tuple(acc.shape[2:])),
                       lane_flat(rows, n), mask.reshape(-1),
                       vals.reshape((-1,) + tuple(vals.shape[2:])))
        return out.view(acc.shape)
    n, E = acc.shape[0], rows.shape[0]
    rows = rows.long()
    ok = mask & (rows >= 0) & (rows < n)
    buf = torch.cat([acc, acc.new_zeros((E,) + tuple(acc.shape[1:]))])
    overflow = n + torch.arange(E, device=acc.device)
    buf.index_put_((torch.where(ok, rows, overflow),),
                   torch.where(mask[:, None], vals, 0.0), accumulate=True)
    return buf[:n]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane row gather: ``x`` (B, n, ...) at ``idx`` (B, E) ->
    (B, E, ...)."""
    lanes = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lanes, idx.long()]
