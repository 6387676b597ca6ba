"""Small batched SPD solve, ported from ``smplfitter_tpu.ops.lstsq``."""

from __future__ import annotations

import torch


def solve_spd_unrolled(G: torch.Tensor, rhs: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Batched SPD solve for SMALL static n via fully unrolled Cholesky-Crout.

    ``G``: (..., n, n), ``rhs``: (..., n) or (..., n, k). Only the lower
    triangle of ``G`` is read. Each pivot is clamped at ``eps`` before its
    square root, as in the JAX package. Forward only.
    """
    n = G.shape[-1]
    vec_rhs = rhs.dim() == G.dim() - 1
    if vec_rhs:
        rhs = rhs[..., None]

    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for j in range(n):
        s = G[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = d
        inv_d = 1.0 / d
        inv_diag[j] = inv_d
        for i in range(j + 1, n):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d

    # Forward substitution L y = rhs.
    y = [None] * n
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s * inv_diag[i][..., None]
    # Back substitution L^T x = y.
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s * inv_diag[i][..., None]

    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec_rhs else out
