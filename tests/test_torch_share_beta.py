"""``share_beta``, ``batch_mask``, the known-shape kid factor on a fitter
without the kid column, and the cached fit functions of the port against the
JAX package on the CPU.

The synthetic SMPL (V=432) and SMPL-X (V=660) models, targets of one shared
shape made from a numpy seed, batches off the JAX kernels' 8-wide tile (B =
1, 5, 6). The JAX
package fits on the CPU by its XLA formulation. Limits: betas within 1e-3,
translations within 5e-4, and the shared betas equal across the batch to
1e-5 (their std); ``batch_mask``: a B=8 fit whose last 3 instances are
masked equals the 5-instance fit within 1e-5; the gradient of a B=5
``share_beta`` fit within 1e-3 x max|g| of ``jax.grad`` of the JAX fit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smplfitter_tpu
import smplfitter_tpu_torch
from port_on_cpu import port_model_from

BETA_ATOL = 1e-3
TRANS_ATOL = 5e-4
SHARED_STD = 1e-5
MASK_ATOL = 1e-5
GRAD_REL = 1e-3


@pytest.fixture(scope='module')
def models(body_models_dir):
    out = {}
    for name in ('smpl', 'smplx'):
        jax_bm = smplfitter_tpu.BodyModel(name, 'neutral')
        out[name] = (jax_bm, port_model_from(jax_bm))
    return out


def _targets(jax_bm, batch, seed, pose_std=0.2):
    """Targets of one shape (the first draw's betas) in ``batch`` poses."""
    rng = np.random.default_rng(seed)
    J, S = jax_bm.num_joints, jax_bm.num_betas
    pose = rng.normal(0, pose_std, (batch, 3 * J)).astype(np.float32)
    betas = np.repeat(rng.normal(0, 1, (1, S)).astype(np.float32), batch, axis=0)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    out = jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    return pose, betas, np.array(out['vertices']), np.array(out['joints'])


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(ours, theirs, shared=True):
    for key in ('shape_betas', 'kid_factor', 'scale_corr'):
        if key in theirs:
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=BETA_ATOL, rtol=0,
                                       err_msg=key)
    np.testing.assert_allclose(_np(ours['trans']), _np(theirs['trans']), atol=TRANS_ATOL,
                               rtol=0)
    if shared:
        # scale_fit publishes the shared shape divided by each instance's scale.
        x = _np(ours['shape_betas'])
        if 'scale_corr' in ours:
            x = x * _np(ours['scale_corr'])[:, None]
        assert float(np.std(x, axis=0).max()) < SHARED_STD


# case -> (model, batch, fitter kwargs, call kwargs (targets and weights filled in below))
KW = dict(num_iter=2, beta_regularizer=0.5, final_adjust_rots=True, share_beta=True,
          requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
CASES = {
    'joints': ('smpl', 5, {}, dict(KW, joints=True)),
    'no_joints': ('smpl', 6, {}, dict(KW)),
    'warm_start': ('smpl', 5, {}, dict(KW, joints=True, beta_regularizer=2.0, warm=True)),
    'kid': ('smpl', 6, dict(enable_kid=True), dict(KW, joints=True)),
    'scale_fit': ('smpl', 5, {}, dict(KW, joints=True, scale_fit=True)),
    'static_weights': ('smpl', 6, dict(static=True), dict(KW, joints=True)),
    'call_weights': ('smpl', 5, {}, dict(KW, joints=True, call_weights=True)),
    'smplx': ('smplx', 5, {}, dict(KW, joints=True)),
}


def _fit_pair(models, case, seed):
    name, batch, fkw, ckw = CASES[case]
    jax_bm, bm = models[name]
    pose, betas, tv, tj = _targets(jax_bm, batch, seed)
    rng = np.random.default_rng(seed + 100)
    fkw = dict(fkw)
    if fkw.pop('static', False):
        fkw.update(vertex_weights=rng.uniform(0.1, 2.0, bm.num_vertices).astype(np.float32),
                   joint_weights=rng.uniform(0.1, 2.0, bm.num_joints).astype(np.float32))
    ckw = dict(ckw)
    joints = ckw.pop('joints', False)
    if ckw.pop('warm', False):
        ckw['initial_shape_betas'] = (betas + rng.normal(0, 0.3, betas.shape)).astype(np.float32)
    if ckw.pop('call_weights', False):
        ckw['vertex_weights'] = rng.uniform(0.1, 2.0, (batch, bm.num_vertices)).astype(np.float32)
        ckw['joint_weights'] = rng.uniform(0.1, 2.0, (batch, bm.num_joints)).astype(np.float32)
    args = (tv, tj if joints else None)
    theirs = smplfitter_tpu.BodyFitter(jax_bm, **fkw).fit(*args, **ckw)
    ours = smplfitter_tpu_torch.BodyFitter(bm, **fkw).fit(*args, **ckw)
    return ours, theirs


@pytest.mark.parametrize('case', list(CASES))
def test_share_beta_fit_matches_jax(models, case):
    ours, theirs = _fit_pair(models, case, seed=40 + list(CASES).index(case))
    _check(ours, theirs)


def test_batch_mask_leaves_the_padding_out(models):
    _, bm = models['smpl']
    _, _, tv, tj = _targets(models['smpl'][0], 5, seed=74, pose_std=0.1)
    fitter = smplfitter_tpu_torch.BodyFitter(bm)
    kw = dict(num_iter=2, share_beta=True, beta_regularizer=0.0,
              requested_keys=('shape_betas', 'trans'))
    five = fitter.fit(tv, tj, **kw)
    tv8 = np.concatenate([tv] + [tv[-1:]] * 3)
    tj8 = np.concatenate([tj] + [tj[-1:]] * 3)
    masked = fitter.fit(tv8, tj8, batch_mask=np.array([1] * 5 + [0] * 3, np.float32), **kw)
    unmasked = fitter.fit(tv8, tj8, **kw)
    for key in ('shape_betas', 'trans'):
        np.testing.assert_allclose(_np(masked[key][:5]), _np(five[key]), atol=MASK_ATOL, rtol=0)
    gap = np.abs(_np(unmasked['shape_betas'][0]) - _np(five['shape_betas'][0])).max()
    assert gap > 10 * MASK_ATOL
    # Without share_beta the mask changes nothing: instances never couple.
    kw['share_beta'] = False
    np.testing.assert_array_equal(
        _np(fitter.fit(tv8, tj8, batch_mask=np.zeros(8, np.float32), **kw)['shape_betas']),
        _np(fitter.fit(tv8, tj8, **kw)['shape_betas']))


@pytest.mark.parametrize('batch', [1, 6])
def test_known_pose_share_beta_matches_jax(models, batch):
    jax_bm, bm = models['smpl']
    pose, _, tv, tj = _targets(jax_bm, batch, seed=78, pose_std=0.1)
    kw = dict(share_beta=True, beta_regularizer=0.1)
    theirs = smplfitter_tpu.BodyFitter(jax_bm).fit_with_known_pose(pose, tv, tj, **kw)
    ours = smplfitter_tpu_torch.BodyFitter(bm).fit_with_known_pose(pose, tv, tj, **kw)
    _check(ours, theirs)


@pytest.mark.parametrize('num_iter', [0, 1, 2])
def test_known_shape_kid_without_kid_column_matches_jax(models, num_iter):
    jax_bm, bm = models['smpl']
    rng = np.random.default_rng(90 + num_iter)
    pose = rng.normal(0, 0.3, (5, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (5, 10)).astype(np.float32)
    trans = rng.normal(0, 0.5, (5, 3)).astype(np.float32)
    kid = rng.normal(0, 0.5, (5,)).astype(np.float32)
    out = jax_bm(pose, betas, trans, kid)
    tv, tj = np.array(out['vertices']), np.array(out['joints'])
    kw = dict(kid_factor=kid, num_iter=num_iter, final_adjust_rots=True,
              requested_keys=('pose_rotvecs',))
    for joints in (tj, None):
        theirs = smplfitter_tpu.BodyFitter(jax_bm).fit_with_known_shape(betas, tv, joints, **kw)
        ours = smplfitter_tpu_torch.BodyFitter(bm).fit_with_known_shape(betas, tv, joints, **kw)
        assert ours.keys() == theirs.keys()
        for key in ('orientations', 'pose_rotvecs'):
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=1e-3, rtol=0,
                                       err_msg=key)
        np.testing.assert_allclose(_np(ours['trans']), _np(theirs['trans']), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(_np(ours['kid_factor']), kid)


def test_known_shape_scale_fit_at_num_iter_zero_matches_jax(models):
    """``scale_fit`` takes the JAX package's batch-major formulation too: one
    rotation fit at ``num_iter`` 0."""
    jax_bm, bm = models['smpl']
    rng = np.random.default_rng(95)
    pose = rng.normal(0, 0.3, (5, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (5, 10)).astype(np.float32)
    out = jax_bm(pose, betas)
    tv, tj = np.array(out['vertices']) * 1.1, np.array(out['joints']) * 1.1
    kw = dict(num_iter=0, scale_fit=True, requested_keys=('pose_rotvecs',))
    theirs = smplfitter_tpu.BodyFitter(jax_bm).fit_with_known_shape(betas, tv, tj, **kw)
    ours = smplfitter_tpu_torch.BodyFitter(bm).fit_with_known_shape(betas, tv, tj, **kw)
    np.testing.assert_allclose(_np(ours['pose_rotvecs']), _np(theirs['pose_rotvecs']), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(_np(ours['scale_corr']), _np(theirs['scale_corr']), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(_np(ours['trans']), _np(theirs['trans']), atol=1e-4, rtol=0)


def _loss(res):
    return (res['shape_betas'] ** 2).sum() + (res['trans'] ** 2).sum() + (
        res['pose_rotvecs'] ** 2).sum()


def test_share_beta_gradient_matches_jax(models):
    jax_bm, bm = models['smpl']
    _, _, tv, tj = _targets(jax_bm, 5, seed=61)
    kw = dict(num_iter=1, beta_regularizer=1.0, share_beta=True, final_adjust_rots=True,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
    jax_fitter = smplfitter_tpu.BodyFitter(jax_bm)
    vg = jax.jit(jax.value_and_grad(
        lambda a, b: _loss(jax_fitter.fit(a, b, use_kernels=False, **kw)), argnums=(0, 1)))
    value, grads = vg(jnp.asarray(tv), jnp.asarray(tj))
    fitter = smplfitter_tpu_torch.BodyFitter(bm)
    tv_t = torch.as_tensor(tv).requires_grad_()
    tj_t = torch.as_tensor(tj).requires_grad_()
    loss = _loss(fitter.fit(tv_t, tj_t, **kw))
    ours = torch.autograd.grad(loss, (tv_t, tj_t))
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-4)
    for o, t in zip(ours, grads):
        t = np.asarray(t)
        np.testing.assert_allclose(_np(o), t, atol=GRAD_REL * np.abs(t).max(), rtol=0)


@pytest.fixture(scope='module')
def cached_fns(models):
    kw = dict(num_iter=1, share_beta=True)
    return (smplfitter_tpu.get_cached_fit_fn('smpl', **kw),
            smplfitter_tpu_torch.get_cached_fit_fn('smpl', **kw, device='cpu'))


def test_cached_fit_fn_takes_leading_dims(models, cached_fns):
    theirs_fn, ours_fn = cached_fns
    _, _, tv, tj = _targets(models['smpl'][0], 8, seed=83)
    tv, tj = tv.reshape(2, 4, -1, 3), tj.reshape(2, 4, -1, 3)
    theirs, ours = theirs_fn(tv, tj), ours_fn(tv, tj)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert tuple(ours[key].shape) == tuple(theirs[key].shape)
        assert ours[key].shape[:2] == (2, 4)
    _check({k: v.reshape(8, -1) for k, v in ours.items()},
           {k: np.asarray(v).reshape(8, -1) for k, v in theirs.items()})
    assert smplfitter_tpu_torch.get_cached_fit_fn('smpl', num_iter=1, share_beta=True,
                                                  device='cpu') is ours_fn
    assert (smplfitter_tpu_torch.get_cached_body_model('smpl', device='cpu')
            is smplfitter_tpu_torch.get_cached_body_model('smpl', device='cpu'))


def test_ragged_share_beta_matches_jax(models, cached_fns):
    theirs_fn, ours_fn = cached_fns
    _, _, tv, tj = _targets(models['smpl'][0], 8, seed=85)
    lengths = [3, 1, 4]
    splits = np.cumsum([0] + lengths)
    seqs = [(tv[a:b], tj[a:b]) for a, b in zip(splits[:-1], splits[1:])]
    theirs = theirs_fn.ragged([s[0] for s in seqs], [s[1] for s in seqs])
    ours = ours_fn.ragged([s[0] for s in seqs], [s[1] for s in seqs])
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert [len(x) for x in ours[key]] == lengths
    _check({k: torch.cat(v) for k, v in ours.items()},
           {k: np.concatenate([np.asarray(x) for x in v]) for k, v in theirs.items()})
