"""The PyTorch port's rotation ops and small SPD solve against the JAX package.

Same seeded numpy inputs through both; tolerance 1e-5 absolute on O(1)
outputs (both sides are f32 elementwise math in the same order, so the gap is
a few ulps of compiler reassociation).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smplfitter_tpu.ops import lstsq as jax_lstsq
from smplfitter_tpu.ops import rotation as jax_rot
from smplfitter_tpu_torch.ops import lstsq as port_lstsq
from smplfitter_tpu_torch.ops import rotation as port_rot

TOL = 1e-5


def _rotvecs(rng, shape, max_angle=2.5):
    axis = rng.normal(size=shape + (3,))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(0, max_angle, size=shape + (1,))
    return (axis * angle).astype(np.float32)


def _near_rotations(rng, n, noise=0.3):
    """(n, 3, 3) rotations plus noise: well-conditioned projection inputs."""
    R = np.array(jax_rot.rotvec2mat(_rotvecs(rng, (n,))))
    return (R + noise * rng.normal(size=(n, 3, 3))).astype(np.float32)


def _lm9(x):
    """(n, 3, 3) -> lane-major (9, n, 1)."""
    return np.ascontiguousarray(x.reshape(-1, 9).T[:, :, None])


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), rtol=0, atol=TOL)


def _case_divide_no_nan(rng):
    a = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    b[::5] = 0
    return (port_rot.divide_no_nan(torch.as_tensor(a), torch.as_tensor(b)),
            jax_rot.divide_no_nan(a, b))


def _case_rotvec2mat(rng):
    v = _rotvecs(rng, (4, 24))
    v[0, 0] = 0  # exact identity
    return port_rot.rotvec2mat(torch.as_tensor(v)), jax_rot.rotvec2mat(v)


def _case_matmul3x3(rng):
    a = rng.normal(size=(32, 3, 3)).astype(np.float32)
    b = rng.normal(size=(32, 3, 3)).astype(np.float32)
    return (port_rot.matmul3x3(torch.as_tensor(a), torch.as_tensor(b), transpose_a=True),
            jax_rot.matmul3x3(a, b, transpose_a=True))


def _case_matvec3(rng):
    m = rng.normal(size=(32, 3, 3)).astype(np.float32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    return port_rot.matvec3(torch.as_tensor(m), torch.as_tensor(v)), jax_rot.matvec3(m, v)


def _case_proj_SO3_lm(rng):
    A = _lm9(_near_rotations(rng, 256))
    A[:, 0] = 0  # degenerate -> identity
    return port_rot.proj_SO3_lm(torch.as_tensor(A)), jax_rot.proj_SO3_lm(A)


def _case_matmul3x3_lm(rng):
    a = rng.normal(size=(9, 24, 8)).astype(np.float32)
    b = rng.normal(size=(9, 24, 8)).astype(np.float32)
    return (port_rot.matmul3x3_lm(torch.as_tensor(a), torch.as_tensor(b), transpose_b=True),
            jax_rot.matmul3x3_lm(a, b, transpose_b=True))


def _case_rotvec2mat_lm(rng):
    v = np.ascontiguousarray(_rotvecs(rng, (24, 8)).transpose(2, 0, 1))
    return port_rot.rotvec2mat_lm(torch.as_tensor(v)), jax_rot.rotvec2mat_lm(v)


def _case_mat2rotvec_lm(rng):
    R = np.array(jax_rot.rotvec2mat(_rotvecs(rng, (256,))))
    R[0] = np.eye(3)
    R9 = _lm9(R)
    return port_rot.mat2rotvec_lm(torch.as_tensor(R9)), jax_rot.mat2rotvec_lm(R9)


def _case_align_unit_vectors_lm(rng):
    a = rng.normal(size=(3, 64, 1))
    b = rng.normal(size=(3, 64, 1))
    b[:, 0] = a[:, 0]  # parallel -> identity
    a = (a / np.linalg.norm(a, axis=0)).astype(np.float32)
    b = (b / np.linalg.norm(b, axis=0)).astype(np.float32)
    return (port_rot.align_unit_vectors_lm(torch.as_tensor(a), torch.as_tensor(b)),
            jax_rot.align_unit_vectors_lm(a, b))


CASES = {
    'divide_no_nan': _case_divide_no_nan,
    'rotvec2mat': _case_rotvec2mat,
    'matmul3x3': _case_matmul3x3,
    'matvec3': _case_matvec3,
    'proj_SO3_lm': _case_proj_SO3_lm,
    'matmul3x3_lm': _case_matmul3x3_lm,
    'rotvec2mat_lm': _case_rotvec2mat_lm,
    'mat2rotvec_lm': _case_mat2rotvec_lm,
    'align_unit_vectors_lm': _case_align_unit_vectors_lm,
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_rotation_op_matches_jax(name):
    port_out, jax_out = CASES[name](np.random.default_rng(7))
    _close(port_out, jax_out)


def test_proj_SO3_lm_returns_rotations():
    R = port_rot.proj_SO3_lm(torch.as_tensor(_lm9(_near_rotations(np.random.default_rng(1), 64))))
    R = R[:, :, 0].T.reshape(-1, 3, 3)
    eye = torch.eye(3).expand_as(R)
    assert torch.allclose(R @ R.transpose(1, 2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(R), torch.ones(len(R)), atol=1e-5)


@pytest.mark.parametrize('k', [None, 2])
def test_solve_spd_unrolled_matches_jax(k):
    rng = np.random.default_rng(3)
    n, B = 13, 16
    M = rng.normal(size=(B, n, n))
    G = (M @ M.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    rhs = rng.normal(size=(B, n) if k is None else (B, n, k)).astype(np.float32)
    port_x = port_lstsq.solve_spd_unrolled(torch.as_tensor(G), torch.as_tensor(rhs))
    jax_x = jax_lstsq.solve_spd_unrolled(G, rhs)
    _close(port_x, jax_x)


def test_solve_spd_unrolled_eps_clamps_pivots():
    """A singular G: the pivot clamp (eps) keeps the solve finite on both sides."""
    G = np.zeros((2, 3, 3), np.float32)
    G[:, 0, 0] = 1.0
    rhs = np.ones((2, 3), np.float32)
    port_x = port_lstsq.solve_spd_unrolled(torch.as_tensor(G), torch.as_tensor(rhs), eps=1e-6)
    jax_x = jax_lstsq.solve_spd_unrolled(G, rhs, 1e-6)
    assert torch.isfinite(port_x).all()
    np.testing.assert_allclose(port_x.numpy(), np.asarray(jax_x), rtol=1e-6)
