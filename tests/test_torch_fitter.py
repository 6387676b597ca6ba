"""The port's fit plan, shape-solve operands and whole fit against the JAX package.

The precomputed fields must reproduce the JAX builders (the same f64 host
math, cast to f32: rtol 1e-6). The fit is held to ``smplfitter_tpu.BodyFitter.fit``
on the CPU under bench.py's parity gate: max|d betas| <= 1e-3 and mean
reconstruction errors within 0.01 mm of each other.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import smplfitter_tpu
import smplfitter_tpu_torch
from port_on_cpu import port_model_from

PLAN_TENSORS = ('part_counts', 'center_matrix', 'mjp_joint_membership', 'mjp_joint_counts',
                'mjp_center_matrix', 'J_template_ext', 'bone_ext', 'pm_t_pad', 'default_mesh_vm')
PLAN_STATIC = ('bone_parts', 'leaf_parts', 'bone_pairs', 'assemble_indices', 'children_and_self',
               'is_smpl_family', 'n_betas', 'enable_kid', 'adj_level_buckets')
GRAM_TENSORS = ('weights_pad', 'consts_pose', 'consts_full', 'sd_cm', 'Ksd', 'Lz_e', 'sd1_2d',
                'q', 'W1_col', 'Kc')
FIT_KW = dict(num_iter=3, beta_regularizer=1.0, final_adjust_rots=True,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))


@pytest.fixture(scope='module')
def models(body_models_dir):
    jax_bm = smplfitter_tpu.BodyModel('smpl', 'neutral')
    bm = port_model_from(jax_bm)
    return jax_bm, smplfitter_tpu.BodyFitter(jax_bm), bm, smplfitter_tpu_torch.BodyFitter(bm)


@pytest.fixture(scope='module')
def kid_fitters(models):
    """The two packages' fitters with the kid column (E = 11)."""
    return (smplfitter_tpu.BodyFitter(models[0], enable_kid=True),
            smplfitter_tpu_torch.BodyFitter(models[2], enable_kid=True))


def _fitters(models, kid_fitters, enable_kid):
    return kid_fitters if enable_kid else (models[1], models[3])


@pytest.mark.parametrize('enable_kid', [False, True])
@pytest.mark.parametrize('field', PLAN_TENSORS + PLAN_STATIC)
def test_plan_field_matches_jax(models, kid_fitters, field, enable_kid):
    jax_fitter, fitter = _fitters(models, kid_fitters, enable_kid)
    jax_plan, plan = jax_fitter.plan, fitter.plan
    assert jax_plan.vperm is None  # canonical vertex order on both sides
    ours, theirs = getattr(plan, field), getattr(jax_plan, field)
    if field in PLAN_STATIC:
        assert ours == theirs
    else:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0)


@pytest.mark.parametrize('enable_kid', [False, True])
@pytest.mark.parametrize('field', GRAM_TENSORS + ('n_ext',))
def test_gram_field_matches_jax(models, kid_fitters, field, enable_kid):
    jax_fitter, fitter = _fitters(models, kid_fitters, enable_kid)
    jax_gram, gram = jax_fitter.gram, fitter.gram
    assert jax_gram.vperm is None
    ours, theirs = getattr(gram, field), getattr(jax_gram, field)
    if field == 'n_ext':
        assert ours == theirs == 10 + enable_kid
    else:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0)


def test_plan_part_index_is_the_membership(models):
    jax_plan, plan = models[1].plan, models[3].plan
    parts = plan.parts
    pm = plan.pm_t_pad.numpy()
    assert parts.verts.numpy().tolist() == [
        v for j in range(pm.shape[0]) for v in np.nonzero(pm[j])[0]]
    assert sorted(parts.verts.tolist()) == list(jax_plan.used_vertex_indices)


def _targets(jax_bm, batch, seed):
    rng = np.random.default_rng(seed)
    pose = rng.normal(0, 0.3, (batch, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, 10)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    out = jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    return np.array(out['vertices']), np.array(out['joints'])


def _recon_v2v_mm(jax_bm, res, tv):
    re = jax_bm(*(np.asarray(res[k], np.float32) for k in ('pose_rotvecs', 'shape_betas',
                                                          'trans')))
    return float(np.mean(np.linalg.norm(np.asarray(re['vertices']) - tv, axis=-1)) * 1e3)


@pytest.fixture(scope='module')
def targets(models):
    """One B=32 target set for every fit test (JAX compiles each batch shape once)."""
    return _targets(models[0], 32, seed=3)


def test_fit_matches_jax_under_bench_gate(models, targets):
    jax_bm, jax_fitter, _, fitter = models
    tv, tj = targets
    theirs = jax_fitter.fit(tv, tj, **FIT_KW)
    ours = fitter.fit(tv, tj, **FIT_KW)
    for key in ('pose_rotvecs', 'shape_betas', 'trans', 'orientations',
                'relative_orientations'):
        assert ours[key].shape == tuple(theirs[key].shape), key
        assert torch.isfinite(ours[key]).all(), key
    max_dbeta = np.max(np.abs(ours['shape_betas'].numpy() - np.asarray(theirs['shape_betas'])))
    assert max_dbeta <= 1e-3
    v2v_ours = _recon_v2v_mm(jax_bm, {k: v.numpy() for k, v in ours.items()}, tv)
    v2v_theirs = _recon_v2v_mm(jax_bm, theirs, tv)
    assert abs(v2v_ours - v2v_theirs) <= 0.01


@pytest.mark.parametrize('num_iter,final_adjust', [(1, False), (2, True)])
def test_fit_variants_match_jax(models, targets, num_iter, final_adjust):
    jax_bm, jax_fitter, _, fitter = models
    tv, tj = targets
    kw = dict(num_iter=num_iter, beta_regularizer=1.0, final_adjust_rots=final_adjust,
              requested_keys=('pose_rotvecs', 'relative_orientations'))
    theirs = jax_fitter.fit(tv, tj, **kw)
    ours = fitter.fit(torch.as_tensor(tv), torch.as_tensor(tj), **kw)
    np.testing.assert_allclose(ours['shape_betas'].numpy(), np.asarray(theirs['shape_betas']),
                               atol=1e-3)
    np.testing.assert_allclose(ours['orientations'].numpy(), np.asarray(theirs['orientations']),
                               atol=1e-3)


@pytest.mark.parametrize('option', [
    'fit_vertex_weights', 'static_weights', 'fit_joint_weights', 'known_pose_batch_mask',
])
def test_unported_options_raise(models, targets, option):
    """Misused options raise ValueError: fit weights of the wrong shape,
    per-call weights on a fitter with static ones, a ``batch_mask`` that is
    not (B,)."""
    bm, fitter = models[2:]
    tv, tj = targets
    batch = tv.shape[0]
    V, J = bm.num_vertices, bm.num_joints
    pose = np.zeros((batch, 72), np.float32)
    calls = {
        'fit_vertex_weights': (ValueError, 'vertex_weights', lambda: fitter.fit(
            tv, tj, vertex_weights=np.ones((batch, V - 1), np.float32))),
        'static_weights': (ValueError, 'vertex_weights', lambda: smplfitter_tpu_torch.BodyFitter(
            bm, vertex_weights=np.ones(V + 1, np.float32))),
        'fit_joint_weights': (ValueError, 'static', lambda: smplfitter_tpu_torch.BodyFitter(
            bm, joint_weights=np.ones(J, np.float32)).fit(
                tv, tj, joint_weights=np.ones((batch, J), np.float32))),
        'known_pose_batch_mask': (ValueError, 'batch_mask', lambda: fitter.fit_with_known_pose(
            pose, tv, share_beta=True, batch_mask=np.ones((batch, 1), np.float32))),
    }
    error, match, call = calls[option]
    with pytest.raises(error, match=match):
        call()


def test_import_leaves_out_jax():
    code = ('import sys, smplfitter_tpu_torch, smplfitter_tpu_torch.ops.lbs_kernels; '
            'from smplfitter_tpu_torch import (BodyConverter, BodyFlipper, HandReplacer, '
            'BodyFitterOpt, BodyFlipperOpt, set_matmul_precision, get_matmul_precision); '
            'import smplfitter_tpu_torch.precompile, smplfitter_tpu_torch.download; '
            'import smplfitter_tpu_torch.utils.joint_regressor_training; '
            'import smplfitter_tpu_torch.utils.profiling; '
            'import smplfitter_tpu_torch.parallel.sharding; '
            'assert callable(smplfitter_tpu_torch.BodyFitter.check_kernel_parity); '
            'bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", '
            '"smplfitter_tpu")]; print(bad); sys.exit(1 if bad else 0)')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
