"""The LM substrate's models (dense attention architectures so far)."""
