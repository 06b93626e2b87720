"""Device policy, precision policy and KV int8 rows, and jax-compatible random numbers."""
