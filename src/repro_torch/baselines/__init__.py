"""Comparison baselines of the paper's evaluation (numpy only)."""
