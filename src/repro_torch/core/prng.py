"""The simulator's random key stream: threefry-2x32 keys and draws that
reproduce ``jax.random``'s bits in the partitionable form
(``jax_threefry_partitionable``, the default of the JAX the reference runs
on).

A key is an int64 tensor of shape (..., 2) on the device of the work it
drives, holding the two 32-bit words (hi, lo).

* :func:`key` — ``jax.random.PRNGKey(seed)``;
* :func:`split` — ``jax.random.split``;
* :func:`bits` — 32 random bits a position (int64 in [0, 2**32));
* :func:`uniform` — ``jax.random.uniform`` on [0, 1) in float32;
* :func:`randint` — ``jax.random.randint`` for int32 bounds.

Keys with leading axes draw for each key at once, as ``jax.vmap`` over the
keys would. The device of the key picks the path: on the card each
``split``, ``bits`` and ``uniform`` is one launch of the threefry kernel
(``kernels/threefry``; ``randint`` two, then its modular finish), on the
CPU the plain int64 version (``kernels/threefry/ref.py``, which also
holds :func:`key` and the broadcast :func:`threefry2x32`). Nothing here
reads a value back to the host.
"""
from __future__ import annotations

from repro_torch.kernels.threefry.ops import bits, randint, split, uniform
from repro_torch.kernels.threefry.ref import CHUNK, M32, key, threefry2x32

__all__ = ["M32", "CHUNK", "key", "threefry2x32", "split", "bits",
           "uniform", "randint"]
