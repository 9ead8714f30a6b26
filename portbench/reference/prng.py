"""Threefry-2x32 keys and uniform draws, as ``jax.random`` gives them in
its partitionable form: the key stream the what-if fleet's windows and its
``random`` scheduler use. Plain PyTorch; every 32-bit word is held in an
int64 tensor masked to 32 bits.

* ``key(seed)`` is ``PRNGKey(seed)``: words (0, seed & 0xFFFFFFFF);
* ``split(k, n)``: new key i is the hash of the counter pair (0, i);
* ``uniform(k, shape)``: the hash of each flat index as a (hi, lo) counter
  pair, the two output words xor-ed, its top 23 bits the mantissa of a
  float in [1, 2), minus 1.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 1 << 22


def key(seed: int, device) -> torch.Tensor:
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def _rotl(v, r):
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
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


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    """(2,) key -> (n, 2) keys."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[0], k[1], idx >> 32, idx & M32)
    return torch.stack([b0, b1], dim=-1)


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """(2,) key -> float32 draws on [0, 1) of ``shape``."""
    n = math.prod(shape)
    parts = []
    for lo in range(0, n, CHUNK):
        idx = torch.arange(lo, min(n, lo + CHUNK), dtype=torch.int64,
                           device=k.device)
        b0, b1 = threefry2x32(k[0], k[1], idx >> 32, idx & M32)
        f = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
        parts.append((f.view(torch.float32) - 1.0).clamp_min(0.0))
    return torch.cat(parts).reshape(shape)
