"""Attention references and the hand-written CUDA kernels that replace the TPU kernels."""
