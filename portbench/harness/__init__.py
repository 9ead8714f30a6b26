"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``):
inputs from the seed, the cells' drivers, the reduction of traces to
metrics, the yardstick and the comparison that decides ``correct``."""
