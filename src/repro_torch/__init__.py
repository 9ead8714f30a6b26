"""AGOCS simulator in PyTorch, with hand-written CUDA kernels for Hopper.

The single-trajectory simulator of ``repro`` (the JAX package, which stays
the reference) ported to PyTorch: packed event windows stream into
``core.engine.run_windows`` through ``core.pipeline.Simulation``; the
scheduler's score matrix, its sequential commit scan, the per-window stats
sweep and the accounting resync each run one kernel from ``csrc/``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version instead. This package imports neither ``jax`` nor ``repro``.
"""
__all__ = ["device"]
