"""Workloads: each defines a config, a Task and its datasets."""
