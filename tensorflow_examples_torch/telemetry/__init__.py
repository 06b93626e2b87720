"""Metrics registry and its Prometheus rendering."""
