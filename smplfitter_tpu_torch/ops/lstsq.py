"""Batched least squares on normal equations and the small unrolled SPD
solve, ported from ``smplfitter_tpu.ops.lstsq``.

:func:`lstsq`, :func:`normal_equations`, :func:`cholesky_solve` and
:func:`lstsq_partial_share` are the public batch-major least-squares API
(design matrices (B, N, P)); the fits run their own lane-major solves
(:func:`solve_spd_unrolled`, ``shape_gram``). The Gramians are f32 products
(no TF32: ``ops.precision``) and the factorizations ``torch.linalg.cholesky``.

The only sums over the batch are those of the shared solves
(:func:`batch_reduce_sum`). Under batch sharding
(``parallel.sharding.cross_shard``) each rank holds a slice of the batch and
these sums are completed across the ranks. They are taken in f64 and rounded
once, where the JAX package sums in f32: the shared solutions of
:func:`lstsq` (``shared=True``) and :func:`lstsq_partial_share` then differ
from the JAX package's by its f32 rounding of the sum, which
``tests/test_torch_refine.py`` holds within 1e-5 x max|JAX|.
"""

from __future__ import annotations

import contextvars
import warnings
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

# Inside a ``parallel.sharding.cross_shard`` region, a 1-tuple of the process
# group whose ranks hold the batch's slices (None in it: the default group).
# A ContextVar, so that a region is scoped to the code that opened it.
CROSS_SHARD_GROUP: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    'smplfitter_torch_cross_shard_group', default=None)

# The autograd-aware all_reduce warns that it is deprecated on every call; the
# replacement it names has no backward pass. Silenced for this module's calls.
warnings.filterwarnings('ignore', category=FutureWarning, module=__name__,
                        message=r'torch\.distributed\.nn\.functional\.all_reduce is deprecated')


def batch_reduce_sum(x: torch.Tensor, axis=0, keepdims: bool = False) -> torch.Tensor:
    """Sum over the batch axis in f64, rounded once to ``x``'s dtype: a padded
    batch whose padding adds zeros then sums to the unpadded batch's value
    whatever the order of the reduction. Inside a ``cross_shard`` region the
    f64 sum is completed by an all-reduce over the region's group
    (``torch.distributed.nn.functional.all_reduce``, so gradients flow back
    to every rank's slice)."""
    s = x.double().sum(dim=axis, keepdim=keepdims)
    region = CROSS_SHARD_GROUP.get()
    if region is not None:
        from torch.distributed.nn.functional import all_reduce

        s = all_reduce(s, group=region[0])
    return s.to(x.dtype)


def normal_equations(matrix: torch.Tensor, rhs: torch.Tensor, weights: torch.Tensor,
                     ridge: Optional[torch.Tensor] = None,
                     ridge_rhs: Optional[torch.Tensor] = None):
    """The normal equations of a weighted least-squares system: the Gramian
    ``A^T W A`` (..., P, P) and the moment ``A^T W b`` (..., P, K); ``ridge``
    (P,) adds a Tikhonov diagonal and ``ridge_rhs`` a term to the moment."""
    row_scaled = matrix * weights[..., None]
    gram = torch.einsum('...ji,...jk->...ik', row_scaled, matrix)
    moment = torch.einsum('...ji,...jk->...ik', row_scaled, rhs)
    if ridge is not None:
        gram = gram + torch.diag(ridge)
    if ridge_rhs is not None:
        moment = moment + ridge_rhs
    return gram, moment


def cholesky_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = rhs`` given the lower Cholesky factor, batched."""
    return torch.cholesky_solve(rhs, chol, upper=False)


def lstsq(matrix: torch.Tensor, rhs: torch.Tensor, weights: torch.Tensor,
          l2_regularizer: Optional[torch.Tensor] = None,
          l2_regularizer_rhs: Optional[torch.Tensor] = None,
          shared: bool = False) -> torch.Tensor:
    """Solve ``argmin_x ||sqrt(w) (matrix @ x - rhs)||^2 + x^T diag(l2) x - 2 x^T l2_rhs``.

    ``matrix`` (B, N, P), ``rhs`` (B, N, K), ``weights`` (B, N),
    ``l2_regularizer`` (P,), ``l2_regularizer_rhs`` (B, P, K). With
    ``shared`` the Gramian and moment are summed over the batch: one
    solution (1, P, K) for all instances; else (B, P, K).
    """
    gram, moment = normal_equations(matrix, rhs, weights, l2_regularizer, l2_regularizer_rhs)
    if shared:
        gram = batch_reduce_sum(gram, axis=0, keepdims=True)
        moment = batch_reduce_sum(moment, axis=0, keepdims=True)
    return cholesky_solve(torch.linalg.cholesky(gram), moment)


def lstsq_partial_share(matrix: torch.Tensor, rhs: torch.Tensor, weights: torch.Tensor,
                        l2_regularizer: torch.Tensor,
                        l2_regularizer_rhs: Optional[torch.Tensor] = None,
                        n_shared: int = 0,
                        batch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch least squares whose first ``n_shared`` parameters are shared by
    the batch, by Schur-complement elimination on the partitioned normal
    equations: each instance eliminates its independent block, the (S, S)
    Schur complements and their moments are summed over the batch, and the
    independent parameters are recovered by back substitution. The Tikhonov
    diagonal applies per instance, ``l2_regularizer_rhs`` enters scaled by
    the regularizer. ``batch_mask`` (B,) zeroes instances' contributions to
    the shared sums, so padding instances leave the shared solution as it
    is. Returns (B, P, K).
    """
    n_params = matrix.shape[-1]
    n_out = rhs.shape[-1]
    batch = matrix.shape[0]
    pull = None if l2_regularizer_rhs is None else l2_regularizer[:, None] * l2_regularizer_rhs
    gram, moment = normal_equations(matrix, rhs, weights, l2_regularizer, pull)

    if n_params == n_shared:
        if batch_mask is not None:
            gram = gram * batch_mask[:, None, None]
            moment = moment * batch_mask[:, None, None]
        gram = batch_reduce_sum(gram, axis=0, keepdims=True)
        moment = batch_reduce_sum(moment, axis=0, keepdims=True)
        result = cholesky_solve(torch.linalg.cholesky(gram), moment)
        return result.expand(batch, n_params, n_out)

    g_ss = gram[..., :n_shared, :n_shared]
    g_si = gram[..., :n_shared, n_shared:]
    g_ii = gram[..., n_shared:, n_shared:]
    m_s = moment[..., :n_shared, :]
    m_i = moment[..., n_shared:, :]

    # Local elimination of the independent block, for coupling and moment at once.
    eliminated = cholesky_solve(torch.linalg.cholesky(g_ii),
                                torch.cat([g_si.transpose(-1, -2), m_i], dim=-1))
    pivot_s = eliminated[..., :n_shared]  # Gii^-1 Gis, (B, I, S)
    pivot_k = eliminated[..., n_shared:]  # Gii^-1 bi, (B, I, K)

    schur_contrib = g_ss - g_si @ pivot_s
    moment_contrib = m_s - g_si @ pivot_k
    if batch_mask is not None:
        schur_contrib = schur_contrib * batch_mask[:, None, None]
        moment_contrib = moment_contrib * batch_mask[:, None, None]
    schur = batch_reduce_sum(schur_contrib, axis=0, keepdims=True)
    schur_moment = batch_reduce_sum(moment_contrib, axis=0, keepdims=True)
    x_shared = cholesky_solve(torch.linalg.cholesky(schur), schur_moment)  # (1, S, K)

    x_indep = pivot_k - pivot_s @ x_shared
    return torch.cat([x_shared.expand(batch, n_shared, n_out), x_indep], dim=1)


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
