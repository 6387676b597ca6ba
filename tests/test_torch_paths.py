"""The port's other fitting paths against the JAX package on the CPU.

Fits without target joints, warm starts, the kid factor, ``scale_target`` /
``scale_fit``, the 'vertices' / 'joints' outputs, ``fit_with_known_pose``,
``fit_with_known_shape`` and ``fit_scale_and_translation`` of
``smplfitter_tpu_torch.BodyFitter`` are held to ``smplfitter_tpu.BodyFitter``
(its XLA formulation on the CPU) on the synthetic SMPL model (V=432), one
batch of B=8 made from a numpy seed. The gate is bench.py's: max|d betas|
<= 1e-3 (also for the kid factor and the scale) and mean reconstruction errors
within 0.01 mm of each other; orientations within 1e-3 and translations
within 1e-4. Both sides are f32 with sums in other orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import smplfitter_tpu
import smplfitter_tpu_torch
from port_on_cpu import port_model_from

BATCH = 8
PARAM_ATOL = 1e-3  # betas, kid factor, scale
ROT_ATOL = 1e-3
TRANS_ATOL = 1e-4
V2V_MM = 0.01


@pytest.fixture(scope='module')
def setup(body_models_dir):
    jax_bm = smplfitter_tpu.BodyModel('smpl', 'neutral')
    bm = port_model_from(jax_bm)
    fitters = {kid: (smplfitter_tpu.BodyFitter(jax_bm, enable_kid=kid),
                     smplfitter_tpu_torch.BodyFitter(bm, enable_kid=kid))
               for kid in (False, True)}
    rng = np.random.default_rng(11)
    params = dict(
        pose=rng.normal(0, 0.3, (BATCH, 72)).astype(np.float32),
        betas=rng.normal(0, 1, (BATCH, 10)).astype(np.float32),
        trans=rng.normal(0, 0.5, (BATCH, 3)).astype(np.float32),
        kid=rng.normal(0, 0.5, (BATCH,)).astype(np.float32),
    )
    out = jax_bm(params['pose'], params['betas'], params['trans'], params['kid'])
    return jax_bm, fitters, params, np.array(out['vertices']), np.array(out['joints'])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _recon_v2v_mm(jax_bm, res, tv):
    kid = res.get('kid_factor')
    re = jax_bm(glob_rotmats=_np(res['orientations']), shape_betas=_np(res['shape_betas']),
                trans=_np(res['trans']), kid_factor=None if kid is None else _np(kid))
    return float(np.mean(np.linalg.norm(np.asarray(re['vertices']) - tv, axis=-1)) * 1e3)


def _check(jax_bm, ours, theirs, tv):
    """The fit gate; every output of the JAX fit must be in ours, same shape."""
    for key, value in theirs.items():
        assert key in ours, key
        assert tuple(ours[key].shape) == tuple(np.shape(value)), key
        assert torch.isfinite(ours[key]).all(), key
    for key in ('shape_betas', 'kid_factor', 'scale_corr'):
        if key in theirs:
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=PARAM_ATOL,
                                       rtol=0, err_msg=key)
    for key in ('orientations', 'relative_orientations'):
        np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=ROT_ATOL, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(_np(ours['trans']), _np(theirs['trans']), atol=TRANS_ATOL, rtol=0)
    for key in ('vertices', 'joints'):
        if key in theirs:
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=1e-4, rtol=0,
                                       err_msg=key)
    assert abs(_recon_v2v_mm(jax_bm, ours, tv) - _recon_v2v_mm(jax_bm, theirs, tv)) <= V2V_MM


# name -> (enable_kid, with target joints, keyword arguments of fit; 'warm'
# marks a warm start from perturbed parameters)
FIT_CASES = {
    'no_joints_vertices_out': (False, False, dict(
        num_iter=3, final_adjust_rots=True,
        requested_keys=('pose_rotvecs', 'vertices', 'joints'))),
    'flipper_kid_warm_start': (True, False, dict(
        num_iter=1, final_adjust_rots=True, beta_regularizer=1e-2, beta_regularizer2=1e-2,
        kid_regularizer=1e9, warm=True)),
    'warm_start_joints': (False, True, dict(num_iter=2, warm=True)),
    'kid_joints': (True, True, dict(num_iter=2, requested_keys=('pose_rotvecs', 'joints'))),
    'scale_fit_joints': (False, True, dict(num_iter=3, scale_fit=True)),
    'scale_target_no_joints': (False, False, dict(num_iter=2, scale_target=True)),
}


@pytest.mark.parametrize('case', list(FIT_CASES))
def test_fit_matches_jax(setup, case):
    jax_bm, fitters, params, tv, tj = setup
    kid, with_joints, kw = FIT_CASES[case]
    kw = dict(kw)
    if kw.pop('warm', False):
        kw.update(initial_pose_rotvecs=params['pose'] + 0.05,
                  initial_shape_betas=params['betas'] + 0.1)
        if kid:
            kw['initial_kid_factor'] = params['kid'] + 0.1
    jax_fitter, fitter = fitters[kid]
    theirs = jax_fitter.fit(tv, tj if with_joints else None, **kw)
    ours = fitter.fit(tv, tj if with_joints else None, **kw)
    _check(jax_bm, ours, theirs, tv)


@pytest.mark.parametrize('with_joints', [False, True])
def test_fit_with_known_pose_matches_jax(setup, with_joints):
    """The converter's call (no joints, kid factor), and with joints a scale column."""
    jax_bm, fitters, params, tv, tj = setup
    kw = dict(scale_target=True) if with_joints else {}
    jax_fitter, fitter = fitters[not with_joints]
    args = (params['pose'], tv, tj if with_joints else None)
    _check(jax_bm, fitter.fit_with_known_pose(*args, **kw),
           jax_fitter.fit_with_known_pose(*args, **kw), tv)


@pytest.mark.parametrize('with_joints,scale_fit', [(False, False), (True, False), (True, True)])
def test_fit_with_known_shape_matches_jax(setup, with_joints, scale_fit):
    jax_bm, fitters, params, tv, tj = setup
    kid = not with_joints  # the converter's call: no joints, kid factor
    kw = dict(num_iter=3, final_adjust_rots=True, scale_fit=scale_fit,
              requested_keys=('pose_rotvecs',))
    if kid:
        kw['kid_factor'] = params['kid']
    jax_fitter, fitter = fitters[kid]
    args = (params['betas'], tv, tj if with_joints else None)
    _check(jax_bm, fitter.fit_with_known_shape(*args, **kw),
           jax_fitter.fit_with_known_shape(*args, **kw), tv)


@pytest.mark.parametrize('scale', [False, True])
def test_fit_scale_and_translation_matches_jax(setup, scale):
    jax_bm, fitters, params, tv, tj = setup
    rng = np.random.default_rng(2)
    ref_v = (tv * 0.9 + rng.normal(0, 0.01, tv.shape)).astype(np.float32)
    ref_j = (tj * 0.9 + rng.normal(0, 0.01, tj.shape)).astype(np.float32)
    jax_fitter, fitter = fitters[False]
    for joints in ((None, None), (tj, ref_j)):
        ours = fitter.fit_scale_and_translation(tv, ref_v, *joints, scale=scale)
        theirs = jax_fitter.fit_scale_and_translation(tv, ref_v, *joints, scale=scale)
        assert ours.keys() == theirs.keys()
        for key in ours:
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=1e-5, rtol=0)
