"""PyTorch/CUDA port of tensorflow_examples_tpu.

The package mirrors the JAX package's layout and names (``core``,
``models``, ``ops``, ``serving``, ``telemetry``) so each module's
counterpart is easy to find. It imports torch, numpy and the standard
library only; the JAX package stays the reference the tests hold it
against. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (``core/device.py``).
"""
