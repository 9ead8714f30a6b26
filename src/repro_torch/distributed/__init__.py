"""Logical-axis sharding over a ``DeviceMesh`` and the placement trees,
gradient compression and the fault-tolerant training loop."""
