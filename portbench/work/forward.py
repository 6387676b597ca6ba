"""Operations and bytes of the forward pass's per-vertex stage, from the
cell's shapes (conventions as in ``work/fit.py``): the pose-corrective and
shape template of every vertex, F = P + 1 + E + 1 columns (pose feature,
template, betas, kid factor), blended by its nonzero skinning weights and
written once (K1)."""

from __future__ import annotations


def stages(s):
    B, V, J, F = s['B'], s['V'], s['J'], s['P'] + 1 + s['E'] + 1
    f = 2.0 * B * (V * (3 * F + 12) + 12 * s['nnz'])
    b = 4.0 * (12 * J * B + F * B + V * J + 3 * V * F + 3 * V * B)
    return [('lbs_points', f, b)]
