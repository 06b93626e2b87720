"""Serving: engine, KV pools, continuous batcher, HTTP frontend."""
