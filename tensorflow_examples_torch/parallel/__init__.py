"""Mixture-of-Experts dispatch (single program; expert parallelism over a mesh is a later slice)."""
