"""Numpy datasets and iterators (no torch, no jax)."""
