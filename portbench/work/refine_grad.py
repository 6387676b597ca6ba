"""Operations and bytes of the refiner step's kernel stages, from the cell's
shapes (conventions as in ``work/fit.py``): the forward pass's K1 as in
``work/forward.py``, and K10, its backward, counted as the port's smoke test
counts it (``chip_smoke.backward_work``): per (vertex, column) the posed
template and the feature reduction (3F each), Rbar^T g (9), and per nonzero
skinning weight the blended rotation (9) and the 12 dpj fields (12); the
cotangent, [R|t], features, weights and template projectors read once, dpj
and dfeat written once. The torch ops of FK, the loss and their backward
passes are not counted."""

from __future__ import annotations

from portbench.work import forward


def lbs_points_bwd(s):
    """The VJP of the extended LBS (K10): dpj (12, J, B) and dfeat (F, B)."""
    B, V, J, F = s['B'], s['V'], s['J'], s['P'] + 1 + s['E'] + 1
    f = 2.0 * B * (V * (6 * F + 9) + 21 * s['nnz'])
    b = 4.0 * (3 * V * B + 12 * J * B + F * B + V * J + 3 * V * F + (12 * J + F) * B)
    return f, b


def stages(s):
    return forward.stages(s) + [('lbs_points_bwd', *lbs_points_bwd(s))]
