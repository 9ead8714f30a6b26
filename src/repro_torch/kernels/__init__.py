"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each ``<name>/ops.py`` dispatches on the tensor's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes ``<name>/ref.py``.
"""
