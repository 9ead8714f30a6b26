"""Asynchronous, atomic, keep-K checkpoints in the reference's layout."""
