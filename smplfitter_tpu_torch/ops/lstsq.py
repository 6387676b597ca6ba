"""Small batched SPD solve, ported from ``smplfitter_tpu.ops.lstsq``."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def solve_spd_unrolled(G: torch.Tensor, rhs: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Batched SPD solve for SMALL static n via fully unrolled Cholesky-Crout.

    ``G``: (..., n, n), ``rhs``: (..., n) or (..., n, k). Only the lower
    triangle of ``G`` is read. Each pivot is clamped at ``eps`` before its
    square root, as in the JAX package. Carries the JAX package's closed-form
    VJP (one more unrolled solve and an outer product) instead of autograd
    through the factorization: the cotangent of ``G`` lives on its lower
    triangle, the off-diagonal entries holding both symmetric partners.
    """
    return _SolveSPD.apply(G, rhs, eps)


class _SolveSPD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, G, rhs, eps):
        x = _solve_spd_impl(G, rhs, eps)
        ctx.eps = eps
        ctx.save_for_backward(G, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # x = A^-1 b with A the symmetric matrix of G's lower triangle:
        # b_bar = A^-1 x_bar, A_bar = -b_bar x^T (summed over rhs columns),
        # folded onto the lower triangle: G_bar[i, j] = A_bar[i, j] + A_bar[j, i]
        # (i > j), G_bar[j, j] = A_bar[j, j].
        G, x = ctx.saved_tensors
        rhs_bar = _solve_spd_impl(G, g, ctx.eps)
        if x.dim() == G.dim() - 1:
            A_bar = -rhs_bar[..., :, None] * x[..., None, :]
        else:
            A_bar = -torch.einsum('...ik,...jk->...ij', rhs_bar, x)
        n = G.shape[-1]
        lower = torch.tril(torch.ones((n, n), dtype=torch.bool, device=G.device), -1)
        eye = torch.eye(n, dtype=A_bar.dtype, device=G.device)
        G_bar = A_bar * eye + torch.where(lower, A_bar + A_bar.transpose(-1, -2),
                                          torch.zeros_like(A_bar))
        return G_bar, rhs_bar, None


def _solve_spd_impl(G: torch.Tensor, rhs: torch.Tensor, eps: float) -> torch.Tensor:
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
