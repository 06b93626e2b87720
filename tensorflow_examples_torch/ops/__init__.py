"""Attention, losses and cross-entropy, and the hand-written CUDA kernels that replace the TPU kernels."""
