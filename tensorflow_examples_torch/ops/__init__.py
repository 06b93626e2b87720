"""Attention, losses, cross-entropy and grouped matmuls, and the hand-written
CUDA kernels that replace the TPU kernels."""
