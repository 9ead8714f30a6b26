"""Gradient compression and the fault-tolerant training loop. Meshes,
sharding rules and collectives wait for a later slice of the port (ROADMAP
Queue 1)."""
