"""Device policy and KV-cache int8 quantization."""
