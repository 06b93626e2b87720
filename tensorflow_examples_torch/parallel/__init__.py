"""Parallel building blocks: Mixture-of-Experts dispatch (single program and expert
parallel), mesh attention, ring and Ulysses context parallelism, and pipeline schedules."""
