"""The yardstick's constants and its sum of a call's least time.

Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit): float32
on the CUDA cores outside the tensor cores, and device memory bandwidth. A
stage's least time is the larger of its operations over the first and its
bytes over the second; a call's is the sum over its stages.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(stages) -> float:
    """Sum over ``(name, flops, bytes)`` stages of max(flops / peak, bytes / bandwidth)."""
    return sum(max(f / PEAK_F32_FLOPS, b / PEAK_BYTES_PER_S) for _, f, b in stages)


def flops(stages) -> float:
    return sum(f for _, f, _ in stages)
