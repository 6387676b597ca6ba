"""Operations and bytes of the closed-form fit's kernel stages, from the cell's
shapes alone, so that the count reads the same work whatever implements it.

Conventions (copied from the port's smoke test, ``kernel_work``): each input
is read once and each output written once; operations are 2 per FMA; blends
over the joints count one FMA per nonzero skinning weight (``nnz``: over all
vertices, ``nnz_used``: over the vertices of the parts the rotation fits
read, ``used``); per-part sums count only those vertices; a weighted stage
adds its weights' bytes and one multiply per weighted term. The stages are
those of the route the shapes select: a pose-corrective template wider than
``HOMOG_GEMM_MIN_F`` is posed once per solve by its own stage and read by
the moment stage, and a shape-moment tensor over ``TERM1_STREAM_MIN_BYTES``
streams term1 by its own stage (its small terms are not counted).

Shapes: B bodies, V vertices, J joints, E shape columns, P pose-corrective
rows, nnz, used, nnz_used, num_iter, weighted.
"""

from __future__ import annotations

HOMOG_GEMM_MIN_F = 320
TERM1_STREAM_MIN_BYTES = 2.75 * 2 ** 20


def rhs_moments(s, cached: bool):
    """The residual's moments over the vertices (K2); ``cached`` reads a
    posed template, else poses it (F = P + 1 per vertex) and writes it."""
    B, V, J, E, F = s['B'], s['V'], s['J'], s['E'], s['P'] + 1
    per = 12 + 3 + 9 + 3 * E + (0 if cached else 3 * F)
    ins = 3 * V * B + 12 * J * B + V * J + 3 * V * E + (3 * V * B if cached
                                                        else F * B + 3 * V * F)
    outs = (3 * J + E) * B + (0 if cached else 3 * V * B)
    return 2.0 * B * (V * per + 15 * s['nnz']), 4.0 * (ins + outs)


def posed_template(s):
    """The pose-corrective template of every vertex (K7)."""
    B, V, F = s['B'], s['V'], s['P'] + 1
    return 2.0 * 3 * V * F * B, 4.0 * (F * B + 3 * V * F + 3 * V * B)


def gram(s):
    """The per-body Gramian of the shape solve from joint-space moments (K3)."""
    B, J, E = s['B'], s['J'], s['E']
    J3 = 3 * J
    per = (J3 * J3 * (E * E + 3) + 3 * J3 * E * J + 3 * E * E * J * 3 + 3 * E * J * J
           + 3 * J3 * E + 6 * E * J)
    ins = (9 * J + 3 * E * J + 3 * J + 3 * E * J + 3 * J) * B + (
        J3 * J3 * E * E + J3 * E * J + J3 * E + J * J + J)
    return 2.0 * B * per, 4.0 * (ins + (E * E + 3 * E + E + 3) * B)


def term1(s):
    """The Gramian's rotation term Ksd^T X alone (K8)."""
    B, J, E = s['B'], s['J'], s['E']
    J3 = 3 * J
    return 2.0 * B * J3 * J3 * (E * E + 3), 4.0 * (3 * J3 * B + J3 * J3 * E * E + E * E * B)


def wgram(s):
    """The per-vertex weighted normal equations of the shape solve (K9)."""
    B, V, J, E = s['B'], s['V'], s['J'], s['E']
    pairs = E * (E + 1) // 2
    per = 9 * E + 9 + 4 * pairs + 7 * E + 4
    ins = 7 * V * B + 12 * J * B + 3 * E * J * B + V * J + 3 * V * E + 3 * E * B
    return (2.0 * B * (V * per + (12 + 3 * E) * s['nnz']),
            4.0 * (ins + (E * E + 4 * E + 4) * B))


def part_sums(s, weighted: bool):
    """Per-part sums of the targets against a batch-constant mesh (the first
    rotation fit's T-pose)."""
    B, V, J, Vu = s['B'], s['V'], s['J'], s['used']
    f, b = Vu * B * 24.0, 4.0 * (3 * Vu * (B + 1) + 15 * J * B)
    if weighted:
        f, b = f + 2.0 * 4 * V * B, b + 4.0 * Vu * B
    return f, b


def recon_part_sums(s, weighted: bool):
    """Per-part sums of the targets against the solved mesh, made on the fly
    from the solve's posed template, shape columns and [R|t] (K4)."""
    B, V, J, E, Vu = s['B'], s['V'], s['J'], s['E'], s['used']
    per = 3 * E + 3 + 12 + 15
    f = 2.0 * B * (Vu * per + 12 * s['nnz_used'])
    b = 4.0 * (6 * Vu * B + 12 * J * B + E * B + Vu * (3 * E + J) + 15 * J * B)
    if weighted:
        f, b = f + 2.0 * 4 * V * B, b + 4.0 * Vu * B
    return f, b


def stages(s):
    """[(stage, operations, bytes)] of one call of the headline fit (target
    joints, final adjustment), per-call weighted or not."""
    weighted = s['weighted']
    large_f = s['P'] + 1 > HOMOG_GEMM_MIN_F
    streamed = (3 * s['J']) ** 2 * s['E'] ** 2 * 4 > TERM1_STREAM_MIN_BYTES
    solve = []
    if weighted:
        solve += [('posed_template', *posed_template(s)), ('wgram', *wgram(s))]
    else:
        if large_f:
            solve += [('posed_template', *posed_template(s)),
                      ('rhs_moments', *rhs_moments(s, cached=True))]
        else:
            solve.append(('rhs_moments', *rhs_moments(s, cached=False)))
        solve.append(('term1', *term1(s)) if streamed else ('gram', *gram(s)))
    n = max(int(s['num_iter']), 1)
    out = solve * n
    out.append(('part_sums', *part_sums(s, weighted)))
    out += [('recon_part_sums', *recon_part_sums(s, weighted))] * n
    return out
