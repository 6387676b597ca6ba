"""Batched SO(3) numerics, ported from ``smplfitter_tpu.ops.rotation``.

Everything is branch-free elementwise math (``torch.where``, never
data-dependent Python control flow), so one code path serves every batch.
The SO(3) projection carries the JAX package's closed-form VJP; the rest is
differentiated by autograd. Rotations in the fit pipeline are "lane-major": ``(9, N, B)`` entry
arrays (row-major entries leading) and ``(3, N, B)`` vectors, matching the
layouts the kernels read and write. The batch-major functions, on (..., 3, 3)
matrices and (..., 3) vectors, are layout adapters over the lane-major cores
where one exists; the 6D representation (:func:`rot6d_to_rotmat`) is the
Adam refiner's parametrization.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

__all__ = [
    'divide_no_nan',
    'rotvec2mat',
    'mat2rotvec',
    'proj_SO3',
    'kabsch',
    'matmul3x3',
    'matvec3',
    'proj_SO3_lm',
    'matmul3x3_lm',
    'rotvec2mat_lm',
    'mat2rotvec_lm',
    'align_unit_vectors_lm',
    'align_unit_vectors',
    'project_onto_plane',
    'rot6d_to_rotmat',
    'rotmat_to_rot6d',
]


def divide_no_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` that returns 0 where ``b == 0``."""
    zero = b == 0
    safe_b = torch.where(zero, torch.ones_like(b), b)
    q = a / safe_b
    return torch.where(zero, torch.zeros_like(q), q)


def rotvec2mat(rotvec: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 3, 3) matrices (via :func:`rotvec2mat_lm`)."""
    R9 = rotvec2mat_lm(torch.movedim(rotvec, -1, 0))
    return torch.movedim(R9, 0, -1).reshape(*rotvec.shape[:-1], 3, 3)


def mat2rotvec(rotmat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 3) rotation vectors (via :func:`mat2rotvec_lm`)."""
    flat = rotmat.reshape(*rotmat.shape[:-2], 9)
    return torch.movedim(mat2rotvec_lm(torch.movedim(flat, -1, 0)), 0, -1)


def proj_SO3(A: torch.Tensor) -> torch.Tensor:
    """Closest rotation (Frobenius norm) to each (..., 3, 3) matrix: a layout
    adapter over :func:`proj_SO3_lm`, with its closed-form VJP."""
    flat = A.reshape(*A.shape[:-2], 9)
    R9 = proj_SO3_lm(torch.movedim(flat, -1, 0).contiguous())
    return torch.movedim(R9, 0, -1).reshape(A.shape)


def kabsch(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Optimal rotation aligning point sets (..., N, 3): proj_SO3(X^T Y)."""
    return proj_SO3(X.transpose(-1, -2) @ Y)


def align_unit_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) mapping unit vectors a -> b (..., 3) (via
    :func:`align_unit_vectors_lm`); parallel vectors give the identity."""
    R9 = align_unit_vectors_lm(torch.movedim(a, -1, 0), torch.movedim(b, -1, 0))
    return torch.movedim(R9, 0, -1).reshape(*R9.shape[1:], 3, 3)


def project_onto_plane(v: torch.Tensor, n_hat: torch.Tensor) -> torch.Tensor:
    """Component of ``v`` perpendicular to the unit vector ``n_hat`` (broadcasts)."""
    return v - (v * n_hat).sum(dim=-1, keepdim=True) * n_hat


def rot6d_to_rotmat(rot6d: torch.Tensor) -> torch.Tensor:
    """6D rotation representation (..., 6) -> rotation matrix (..., 3, 3) by
    Gram-Schmidt: the two 3-vectors become the first two columns."""
    a1 = rot6d[..., :3]
    a2 = rot6d[..., 3:6]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + 1e-8)
    b2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + 1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(rotmat: torch.Tensor) -> torch.Tensor:
    """First two columns of a rotation matrix, concatenated (..., 6)."""
    return torch.cat([rotmat[..., :, 0], rotmat[..., :, 1]], dim=-1)


def matmul3x3(a: torch.Tensor, b: torch.Tensor, transpose_b: bool = False,
              transpose_a: bool = False) -> torch.Tensor:
    """Componentwise (..., 3, 3) @ (..., 3, 3), broadcasting batch dims."""
    af = a.reshape(*a.shape[:-2], 9)
    bf = b.reshape(*b.shape[:-2], 9)
    A = [af[..., i] for i in range(9)]
    B = [bf[..., i] for i in range(9)]

    def ai(i, k):
        return A[k * 3 + i] if transpose_a else A[i * 3 + k]

    def bi(k, j):
        return B[j * 3 + k] if transpose_b else B[k * 3 + j]

    entries = [
        ai(i, 0) * bi(0, j) + ai(i, 1) * bi(1, j) + ai(i, 2) * bi(2, j)
        for i in range(3)
        for j in range(3)
    ]
    out = torch.stack(entries, dim=-1)
    return out.reshape(*out.shape[:-1], 3, 3)


def matvec3(m: torch.Tensor, v: torch.Tensor, transpose_m: bool = False) -> torch.Tensor:
    """Componentwise (..., 3, 3) @ (..., 3), broadcasting batch dims."""
    mf = m.reshape(*m.shape[:-2], 9)
    M = [mf[..., i] for i in range(9)]
    V = [v[..., i] for i in range(3)]

    def mi(i, k):
        return M[k * 3 + i] if transpose_m else M[i * 3 + k]

    return torch.stack(
        [mi(i, 0) * V[0] + mi(i, 1) * V[1] + mi(i, 2) * V[2] for i in range(3)], dim=-1
    )


def _proj_SO3_core(ent):
    """Analytic polar decomposition on a list of 9 same-shaped entry tensors:
    Smith's trigonometric eigenvalues of An^T An, the extreme eigenvector from
    the best-conditioned row-pair cross product, a half-angle 2x2 rotation for
    the rest, and R = U V^T with right-handed bases."""
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = ent

    fro2 = (
        a00 * a00 + a01 * a01 + a02 * a02
        + a10 * a10 + a11 * a11 + a12 * a12
        + a20 * a20 + a21 * a21 + a22 * a22
    )
    fro = torch.sqrt(fro2)
    inv = 1.0 / torch.clamp(fro, min=1e-30)
    a00, a01, a02 = a00 * inv, a01 * inv, a02 * inv
    a10, a11, a12 = a10 * inv, a11 * inv, a12 * inv
    a20, a21, a22 = a20 * inv, a21 * inv, a22 * inv

    m00 = a00 * a00 + a10 * a10 + a20 * a20
    m11 = a01 * a01 + a11 * a11 + a21 * a21
    m22 = a02 * a02 + a12 * a12 + a22 * a22
    m01 = a00 * a01 + a10 * a11 + a20 * a21
    m02 = a00 * a02 + a10 * a12 + a20 * a22
    m12 = a01 * a02 + a11 * a12 + a21 * a22

    qv = (m00 + m11 + m22) / 3.0
    p1 = m01 * m01 + m02 * m02 + m12 * m12
    b00, b11, b22 = m00 - qv, m11 - qv, m22 - qv
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(p2 / 6.0)
    det_shifted = (
        b00 * (b11 * b22 - m12 * m12)
        - m01 * (m01 * b22 - m12 * m02)
        + m02 * (m01 * m12 - b11 * m02)
    )
    rr = torch.clamp(divide_no_nan(det_shifted, 2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(rr) / 3.0
    lam1 = qv + 2.0 * p * torch.cos(phi)
    lam3 = qv + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * qv - lam1 - lam3

    def cross(x, y):
        return (
            x[1] * y[2] - x[2] * y[1],
            x[2] * y[0] - x[0] * y[2],
            x[0] * y[1] - x[1] * y[0],
        )

    def dot(x, y):
        return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]

    def normalize_or(x, fallback, eps):
        n2 = dot(x, x)
        ok = n2 > eps * eps
        invn = torch.rsqrt(torch.where(ok, n2, torch.ones_like(n2)))
        return tuple(torch.where(ok, xi * invn, fi) for xi, fi in zip(x, fallback))

    def matvec_sym(v):
        return (
            m00 * v[0] + m01 * v[1] + m02 * v[2],
            m01 * v[0] + m11 * v[1] + m12 * v[2],
            m02 * v[0] + m12 * v[1] + m22 * v[2],
        )

    def matvec_A(v):
        return (
            a00 * v[0] + a01 * v[1] + a02 * v[2],
            a10 * v[0] + a11 * v[1] + a12 * v[2],
            a20 * v[0] + a21 * v[1] + a22 * v[2],
        )

    def least_aligned_axis(v):
        av0, av1, av2 = torch.abs(v[0]), torch.abs(v[1]), torch.abs(v[2])
        is0 = torch.logical_and(av0 <= av1, av0 <= av2)
        is1 = torch.logical_and(av1 <= av0, av1 <= av2)
        return (
            is0.to(a00.dtype),
            torch.logical_and(is1, ~is0).to(a00.dtype),
            torch.logical_and(~is0, ~is1).to(a00.dtype),
        )

    eps = 1e-9
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    e0 = (one, zero, zero)

    use_top = (lam1 - lam2) >= (lam2 - lam3)
    lam_ext = torch.where(use_top, lam1, lam3)

    r0 = (m00 - lam_ext, m01, m02)
    r1 = (m01, m11 - lam_ext, m12)
    r2 = (m02, m12, m22 - lam_ext)
    c0 = cross(r0, r1)
    c1 = cross(r1, r2)
    c2 = cross(r2, r0)
    n0, n1, n2 = dot(c0, c0), dot(c1, c1), dot(c2, c2)
    pick01 = n0 >= n1
    best = tuple(torch.where(pick01, x, y) for x, y in zip(c0, c1))
    nbest = torch.where(pick01, n0, n1)
    pick = nbest >= n2
    raw = tuple(torch.where(pick, x, y) for x, y in zip(best, c2))
    v_a = normalize_or(raw, e0, eps)

    pvec = cross(v_a, least_aligned_axis(v_a))
    pinv = torch.rsqrt(torch.clamp(dot(pvec, pvec), min=1e-30))
    pvec = tuple(x * pinv for x in pvec)
    qvec = cross(v_a, pvec)

    Mp = matvec_sym(pvec)
    Mq = matvec_sym(qvec)
    mpp = dot(pvec, Mp)
    mpq = dot(pvec, Mq)
    mqq = dot(qvec, Mq)
    th = 0.5 * torch.atan2(2.0 * mpq, mpp - mqq)
    cth, sth = torch.cos(th), torch.sin(th)
    v_big = tuple(cth * pi + sth * qi for pi, qi in zip(pvec, qvec))
    v_small = tuple(-sth * pi + cth * qi for pi, qi in zip(pvec, qvec))

    v1 = tuple(torch.where(use_top, x, y) for x, y in zip(v_a, v_big))
    v2 = tuple(torch.where(use_top, x, y) for x, y in zip(v_big, v_small))
    v3 = cross(v1, v2)

    u1 = normalize_or(matvec_A(v1), e0, eps)
    u2r = matvec_A(v2)
    proj = dot(u2r, u1)
    u2r = tuple(x - proj * u for x, u in zip(u2r, u1))
    fb = cross(u1, least_aligned_axis(u1))
    fbinv = torch.rsqrt(torch.clamp(dot(fb, fb), min=1e-30))
    fb = tuple(x * fbinv for x in fb)
    u2 = normalize_or(u2r, fb, eps)
    u3 = cross(u1, u2)

    U_rows = [(u1[i], u2[i], u3[i]) for i in range(3)]
    V_rows = [(v1[i], v2[i], v3[i]) for i in range(3)]
    entries = [dot(U_rows[i], V_rows[j]) for i in range(3) for j in range(3)]

    # Fully degenerate A ~ 0 -> identity.
    ok = fro > 1e-20
    eye_flat = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    return [torch.where(ok, x, torch.full_like(x, ident)) for x, ident in zip(entries, eye_flat)]


def _proj_SO3_bwd_entries(A, R, G):
    """Closed-form VJP of the SO(3) projection on 9-entry lists (the JAX
    package's ``_proj_SO3_bwd_entries``).

    R is the orthogonal factor of the polar decomposition A = R S, S =
    sym(R^T A). The cotangent pullback is A_bar = R hat(u) with
    u = (tr(S) I - S)^-1 vee2(R^T G), vee2(M) = (M21 - M12, M02 - M20,
    M10 - M01); the 3x3 solve is by adjugate, damped by 1e-6 |tr S| so that
    the gradient stays finite where singular values coalesce under a
    reflection (autograd of the eigensolver gives NaN there).
    """
    def rt_m(M):  # (R^T M) entries, row-major
        return [R[i] * M[j] + R[3 + i] * M[3 + j] + R[6 + i] * M[6 + j]
                for i in range(3) for j in range(3)]

    RtA = rt_m(A)
    s00, s11, s22 = RtA[0], RtA[4], RtA[8]
    s01 = 0.5 * (RtA[1] + RtA[3])
    s02 = 0.5 * (RtA[2] + RtA[6])
    s12 = 0.5 * (RtA[5] + RtA[7])
    trS = s00 + s11 + s22
    lam = 1e-6 * torch.abs(trS) + 1e-20
    l00, l11, l22 = trS - s00 + lam, trS - s11 + lam, trS - s22 + lam
    l01, l02, l12 = -s01, -s02, -s12

    M = rt_m(G)
    r1, r2, r3 = M[7] - M[5], M[2] - M[6], M[3] - M[1]

    c00 = l11 * l22 - l12 * l12
    c01 = l02 * l12 - l01 * l22
    c02 = l01 * l12 - l02 * l11
    c11 = l00 * l22 - l02 * l02
    c12 = l01 * l02 - l00 * l12
    c22 = l00 * l11 - l01 * l01
    det = l00 * c00 + l01 * c01 + l02 * c02
    inv_det = divide_no_nan(torch.ones_like(det), det)
    u1 = (c00 * r1 + c01 * r2 + c02 * r3) * inv_det
    u2 = (c01 * r1 + c11 * r2 + c12 * r3) * inv_det
    u3 = (c02 * r1 + c12 * r2 + c22 * r3) * inv_det

    out = []  # R hat(u): hat(u) columns (0, u3, -u2), (-u3, 0, u1), (u2, -u1, 0)
    for i in range(3):
        ri0, ri1, ri2 = R[i * 3], R[i * 3 + 1], R[i * 3 + 2]
        out += [ri1 * u3 - ri2 * u2, ri2 * u1 - ri0 * u3, ri0 * u2 - ri1 * u1]
    return out


class _ProjSO3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A9):
        R9 = torch.stack(_proj_SO3_core(list(A9.unbind(0))), dim=0)
        ctx.save_for_backward(A9, R9)
        return R9

    @staticmethod
    @once_differentiable
    def backward(ctx, G9):
        A9, R9 = ctx.saved_tensors
        return torch.stack(_proj_SO3_bwd_entries(A9.unbind(0), R9.unbind(0), G9.unbind(0)), dim=0)


def proj_SO3_lm(A9: torch.Tensor) -> torch.Tensor:
    """Closest rotation (Frobenius norm) to each (9, ...) entry matrix, with
    the closed-form polar-differential VJP (:func:`_proj_SO3_bwd_entries`)."""
    return _ProjSO3.apply(A9)


def matmul3x3_lm(a9, b9, transpose_a: bool = False, transpose_b: bool = False):
    """(9, ...) @ (9, ...) componentwise (broadcasting trailing dims)."""
    def ai(i, k):
        return a9[k * 3 + i] if transpose_a else a9[i * 3 + k]

    def bi(k, j):
        return b9[j * 3 + k] if transpose_b else b9[k * 3 + j]

    return torch.stack(
        [
            ai(i, 0) * bi(0, j) + ai(i, 1) * bi(1, j) + ai(i, 2) * bi(2, j)
            for i in range(3)
            for j in range(3)
        ],
        dim=0,
    )


def _quat_to_mat9(qw, qx, qy, qz):
    """Unit quaternion components -> the 9 rotation-matrix entries (row-major)."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return [
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ]


def rotvec2mat_lm(v3: torch.Tensor) -> torch.Tensor:
    """(3, ...) rotation vectors -> (9, ...) matrices through the half-angle
    unit quaternion; the zero-angle limit is the exact identity."""
    angle = torch.sqrt(
        torch.clamp(v3[0] * v3[0] + v3[1] * v3[1] + v3[2] * v3[2], min=1e-30)
    )
    k = torch.sin(0.5 * angle) / angle
    qw = torch.cos(0.5 * angle)
    return torch.stack(_quat_to_mat9(qw, k * v3[0], k * v3[1], k * v3[2]), dim=0)


def mat2rotvec_lm(R9: torch.Tensor) -> torch.Tensor:
    """(9, ...) rotation matrices -> (3, ...) rotation vectors: quaternion
    extraction by anchored candidates (w-anchored for positive trace, else the
    largest diagonal entry), then the log map."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R9.unbind(0)

    mag_w = 1.0 + r00 + r11 + r22  # 4w²
    mag_x = 1.0 + r00 - r11 - r22  # 4x²
    mag_y = 1.0 - r00 + r11 - r22  # 4y²
    mag_z = 1.0 - r00 - r11 + r22  # 4z²

    cand_w = (r21 - r12, r02 - r20, r10 - r01, mag_w)
    cand_x = (mag_x, r01 + r10, r20 + r02, r21 - r12)
    cand_y = (r01 + r10, mag_y, r12 + r21, r02 - r20)
    cand_z = (r20 + r02, r12 + r21, mag_z, r10 - r01)

    use_w = mag_w > 1.0
    x_dominant = torch.logical_and(mag_x > mag_y, mag_x > mag_z)
    y_dominant = mag_y > mag_z
    qx, qy, qz, qw = (
        torch.where(use_w, cw, torch.where(x_dominant, cx, torch.where(y_dominant, cy, cz)))
        for cw, cx, cy, cz in zip(cand_w, cand_x, cand_y, cand_z)
    )
    s = torch.sqrt(torch.clamp(qx * qx + qy * qy + qz * qz, min=1e-30))
    scale = 2.0 * torch.atan2(s, qw) / s
    return torch.stack([scale * qx, scale * qy, scale * qz], dim=0)


def align_unit_vectors_lm(a3, b3) -> torch.Tensor:
    """Rotation mapping unit vectors a -> b, (3, ...) -> (9, ...).

    The sine is clamped away from zero as in :func:`rotvec2mat_lm`: where a
    and b are bitwise parallel, their cross product is exactly zero, and the
    unclamped square root's derivative, infinite there, made the gradient
    NaN (the JAX package's fused products leave a rounding residue there and
    stay finite). The rotation is unchanged: the cross product is zero."""
    cx = a3[1] * b3[2] - a3[2] * b3[1]
    cy = a3[2] * b3[0] - a3[0] * b3[2]
    cz = a3[0] * b3[1] - a3[1] * b3[0]
    dot = a3[0] * b3[0] + a3[1] * b3[1] + a3[2] * b3[2]
    sin_a = torch.sqrt(torch.clamp(cx * cx + cy * cy + cz * cz, min=1e-30))
    f = torch.atan2(sin_a, dot) / sin_a
    return rotvec2mat_lm(torch.stack([cx * f, cy * f, cz * f], dim=0))
