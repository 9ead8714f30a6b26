"""Dispatch for the threefry draws: CUDA keys launch ``csrc/threefry.cu``,
one launch a draw, CPU keys take the plain version (``ref``). Both give the
same bits; :mod:`repro_torch.core.prng` is the public face of both."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.threefry import ref
from repro_torch.kernels.threefry.ref import Shape, as_shape

#: the kernel's finishes of a hashed pair (b0, b1)
PAIRS, BITS, UNIFORM = 0, 1, 2
_DTYPE = {PAIRS: torch.int64, BITS: torch.int64, UNIFORM: torch.float32}


def threefry_cuda(keys: torch.Tensor, n: int, mode: int) -> torch.Tensor:
    """The kernel itself: keys (K, 2) int64 hash the flat counters 0..n-1
    each -> (K, n, 2) int64 pairs (b0, b1) (PAIRS), (K, n) int64 b0 ^ b1
    (BITS) or (K, n) float32 on [0, 1) (UNIFORM); one launch (none for an
    empty draw)."""
    K = keys.shape[0]
    _build.check(keys, "keys", torch.int64, (K, 2))
    out = torch.empty((K, n, 2) if mode == PAIRS else (K, n),
                      dtype=_DTYPE[mode], device=keys.device)
    if out.numel():
        _build.launch("threefry_launch", keys, out, K, n, mode)
        threefry_cuda.launches += 1
    return out


threefry_cuda.launches = 0


def _draw(k: torch.Tensor, n: int, mode: int) -> torch.Tensor:
    """Every key of ``k`` (..., 2) through one launch -> (..., n[, 2])."""
    out = threefry_cuda(k.reshape(-1, 2).contiguous(), n, mode)
    return out.reshape(k.shape[:-1] + out.shape[1:])


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)``: (..., 2) -> (..., n, 2) int64 keys."""
    if k.device.type != "cuda":
        return ref.split(k, n)
    return _draw(k, n, PAIRS)


def bits(k: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """32 random bits at every position of ``shape`` for each key in ``k``
    (..., 2) -> (..., *shape) int64 in [0, 2**32)."""
    if k.device.type != "cuda":
        return ref.bits(k, shape)
    shape = as_shape(shape)
    return _draw(k, math.prod(shape), BITS).reshape(k.shape[:-1] + shape)


def uniform(k: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 on [0, 1) for each key
    in ``k`` (..., 2) -> (..., *shape)."""
    if k.device.type != "cuda":
        return ref.uniform(k, shape)
    shape = as_shape(shape)
    return _draw(k, math.prod(shape), UNIFORM).reshape(k.shape[:-1] + shape)


def randint(k: torch.Tensor, lo: int, hi: int, shape: Shape = ()
            ) -> torch.Tensor:
    """``jax.random.randint(k, shape, lo, hi)`` for int32 bounds -> int64
    values in [lo, hi): the two bit planes of ``bits(split(k), shape)``
    (two launches on the card) through ``ref.randint_finish``."""
    higher, lower = bits(split(k), shape).unbind(k.dim() - 1)
    return ref.randint_finish(higher, lower, lo, hi)
