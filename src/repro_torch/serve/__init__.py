"""Batched LM serving: prefill + greedy decode."""
