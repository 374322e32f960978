"""Synthetic contexts of the paper's datasets (numpy only)."""
