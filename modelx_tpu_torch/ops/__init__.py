"""Tensor ops: plain PyTorch versions, and wrappers over the hand kernels."""
