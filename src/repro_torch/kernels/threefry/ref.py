"""Plain PyTorch version of the threefry key stream (``core/prng``): the
CPU path, and the yardstick the CUDA kernel (``csrc/threefry.cu``) is held
to. Its threefry-2x32 keys and draws reproduce ``jax.random``'s bits in the
partitionable form (``jax_threefry_partitionable``, the default of the JAX
the reference runs on).

A key is an int64 tensor of shape (..., 2) on the device of the work it
drives, holding the two 32-bit words (hi, lo). Every value here lives in an
int64 tensor masked to 32 bits: PyTorch's ``>>`` on int32 is arithmetic and
uint32 has few ops, while int64 holds any uint32 sum and any 32-bit word
shifted left by up to 31 without overflow.

* :func:`key` — ``jax.random.PRNGKey(seed)`` (``threefry_seed``), the seed
  taken as the reference's 32-bit JAX takes it: high word 0 (``seed >>
  32`` of a 32-bit seed), low word ``seed & 0xFFFFFFFF``;
* :func:`split` — ``jax.random.split`` (``_threefry_split_foldlike``): new
  key i is the hash of the counter pair (0, i);
* :func:`bits` — 32 random bits a position, ``bits1 ^ bits2`` of the hash
  of the position's flat index as a (hi, lo) counter pair;
* :func:`uniform` — ``jax.random.uniform`` on [0, 1) in float32;
* :func:`randint` — ``jax.random.randint`` for int32 bounds, the two-draw
  form whose modular multiplier wraps in uint32 (:func:`randint_finish`).

Keys with leading axes draw for each key at once, as ``jax.vmap`` over the
keys would. Draws are counter-based on the flat index, so a large shape is
drawn in chunks of the flat index (:data:`CHUNK`) with the same bits; that
bounds the int64 temporaries. Nothing here reads a value back to the host.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

M32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: flat positions a chunk of one draw covers (bounds the temporaries)
CHUNK = 1 << 23

Shape = Union[int, Sequence[int]]


def as_shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a (2,) int64 key on ``device``, made
    there (a fill, not a copy from the host, which would wait for the
    device's queue)."""
    lo = int(seed) & M32
    return torch.arange(2, dtype=torch.int64, device=device) * lo


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key words (k0, k1); all int64 holding uint32, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash_bits(k: torch.Tensor, n: int, finish=None) -> torch.Tensor:
    """bits1 ^ bits2 of every key in ``k`` (..., 2) at flat counters
    0..n-1 -> (..., n), drawn in chunks of the counter; ``finish`` maps
    each chunk's int64 bits to the result's dtype before the chunks are
    joined (so only one chunk's int64 temporaries exist at a time)."""
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(lead + (1,))
    k1 = k[..., 1].reshape(lead + (1,))
    step = max(1, CHUNK // max(1, math.prod(lead)))
    parts = []
    for lo in range(0, n, step):
        idx = torch.arange(lo, min(n, lo + step), dtype=torch.int64,
                           device=k.device)
        b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
        parts.append(b0 ^ b1 if finish is None else finish(b0 ^ b1))
    if not parts:
        out = torch.zeros(lead + (0,), dtype=torch.int64, device=k.device)
        return out if finish is None else finish(out)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)``: (..., 2) -> (..., n, 2) int64 keys."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[..., 0, None], k[..., 1, None], idx >> 32,
                          idx & M32)
    return torch.stack([b0, b1], dim=-1)


def bits(k: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """32 random bits at every position of ``shape`` for each key in ``k``
    (..., 2) -> (..., *shape) int64 in [0, 2**32)."""
    shape = as_shape(shape)
    return _hash_bits(k, math.prod(shape)).reshape(k.shape[:-1] + shape)


def _to_unit_float(b: torch.Tensor) -> torch.Tensor:
    f = ((b >> 9) | 0x3F800000).to(torch.int32)
    return (f.view(torch.float32) - 1.0).clamp_min(0.0)


def uniform(k: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 on [0, 1) for each key
    in ``k`` (..., 2) -> (..., *shape): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, at least 0."""
    shape = as_shape(shape)
    return _hash_bits(k, math.prod(shape), _to_unit_float).reshape(
        k.shape[:-1] + shape)


def randint(k: torch.Tensor, lo: int, hi: int, shape: Shape = ()
            ) -> torch.Tensor:
    """``jax.random.randint(k, shape, lo, hi)`` for int32 bounds ->
    int64 values in [lo, hi) (``lo`` when hi <= lo): the two draws of 32
    bits ``bits(split(k), shape)`` through :func:`randint_finish`."""
    higher, lower = bits(split(k), shape).unbind(k.dim() - 1)
    return randint_finish(higher, lower, lo, hi)


def randint_finish(higher: torch.Tensor, lower: torch.Tensor, lo: int,
                   hi: int) -> torch.Tensor:
    """randint's modular finish of its two draws of 32 bits: (higher mod
    span) * multiplier + (lower mod span), mod span, with multiplier =
    2**32 mod span computed as (2**16 mod span)**2 mod span; every product
    and sum wraps to 32 bits first, as uint32 arithmetic does."""
    lo, hi = int(lo), int(hi)
    span = 1 if hi <= lo else (hi - lo) & M32
    mult = (((1 << 16) % span) ** 2 & M32) % span
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    return lo + off % span


__all__ = ["M32", "CHUNK", "key", "threefry2x32", "split", "bits",
           "uniform", "randint", "randint_finish"]
