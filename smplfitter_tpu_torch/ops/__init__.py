"""Tensor ops: rotations, the small SPD solve, and the CUDA kernels."""
