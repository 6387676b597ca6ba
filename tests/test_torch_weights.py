"""Fit weights in the port against the JAX package on the CPU.

Static weights (``BodyFitter(vertex_weights=, joint_weights=)``) and per-call
weights (``vertex_weights`` (B, V), ``joint_weights`` (B, J)) on the
synthetic SMPL model (V=432) at B=8, and K9 also on the synthetic SMPL-X
(V=660, J=55, E=16 and 17). Weights are seeded ``uniform(0.1, 2.0)``.

- Weighted plan and shape-solve fields reproduce the JAX build functions (the same
  f64 host math cast to f32): rtol 1e-6.
- The twins of K9 and of the ω forms of K2, K4, K5 and K6, on operands
  captured from the port's weighted paths, against the JAX kernels in
  interpret mode: 2e-5 x max|JAX output| per output, as in
  tests/test_torch_kernels.py (the JAX kernels split their dots into bf16
  parts; the twins are plain f32).
- Fits under the gate of tests/test_torch_paths.py (bench.py's: betas, kid
  and scale within 1e-3, mean reconstruction errors within 0.01 mm;
  orientations within 1e-3, translations within 1e-4).
- The port's static fit equals its own fit with the same weights passed per
  call, broadcast over the batch (the contract of
  tests/test_static_weights.py, on the port): betas and translations within
  1e-5 (absolute plus relative), pose rotation vectors within 1e-4. The two
  run different sums (the f64 moments against K9's per-vertex f32 sums), and
  the fit's own spread under seeded 1e-7 relative changes of its targets
  measured 1.0e-5 to 1.7e-5 in the betas and 2.5e-5 to 1.2e-4 in the pose
  on this CPU, above the gaps between the two (at most 1.0e-5 and 3.1e-5).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import smplfitter_tpu
import smplfitter_tpu_torch
from port_on_cpu import port_model_from
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from test_torch_paths import _check, _np

BATCH = 8
REL_TOL = 2e-5
STATIC_TOL = 1e-5  # betas and translations, absolute plus relative
STATIC_POSE_TOL = 1e-4
CAPTURED = ('wgram_moments', 'rhs_moments', 'rhs_moments_h', 'part_sums_vm_lm',
            'recon_part_sums_lm', 'recon_part_sums_cached_lm')


def _weights(rng, *shape):
    return rng.uniform(0.1, 2.0, shape).astype(np.float32)


@pytest.fixture(scope='module')
def setup(body_models_dir):
    jax_bm = smplfitter_tpu.BodyModel('smpl', 'neutral')
    bm = port_model_from(jax_bm)
    V, J = bm.num_vertices, bm.num_joints
    rng = np.random.default_rng(21)
    w = dict(vw=_weights(rng, BATCH, V), jw=_weights(rng, BATCH, J),
             svw=_weights(rng, V), sjw=_weights(rng, J))
    fitters = {}
    for key, kw in (('plain', {}), ('kid', dict(enable_kid=True)),
                    ('s_vw', dict(vertex_weights=w['svw'])),
                    ('s_both', dict(vertex_weights=w['svw'], joint_weights=w['sjw']))):
        fitters[key] = (smplfitter_tpu.BodyFitter(jax_bm, **kw),
                        smplfitter_tpu_torch.BodyFitter(bm, **kw))
    params = dict(
        pose=rng.normal(0, 0.3, (BATCH, 72)).astype(np.float32),
        betas=rng.normal(0, 1, (BATCH, 10)).astype(np.float32),
        trans=rng.normal(0, 0.5, (BATCH, 3)).astype(np.float32),
        kid=rng.normal(0, 0.5, (BATCH,)).astype(np.float32),
    )
    out = jax_bm(params['pose'], params['betas'], params['trans'], params['kid'])
    return jax_bm, bm, fitters, w, params, np.array(out['vertices']), np.array(out['joints'])


# ---------------------------------------------------------------------------
# Weighted plan and gram fields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('field', ['omega_pad', 'part_counts_w'])
def test_weighted_plan_field_matches_jax(setup, field):
    jax_fitter, fitter = setup[2]['s_vw']
    np.testing.assert_allclose(getattr(fitter.plan, field).numpy(),
                               np.asarray(getattr(jax_fitter.plan, field)), rtol=1e-6, atol=0)
    assert getattr(setup[2]['plain'][1].plan, field) is None


@pytest.mark.parametrize('field', ['Ksd', 'Lz_e', 'sd1_2d', 'q', 'W1_col', 'Kc', 'omega_pad',
                                   'w_total', 'Msd', 'weights_pad', 'consts_full'])
def test_weighted_gram_field_matches_jax(setup, field):
    """The weighted GramData's moments, and its per-vertex operands, which
    are the unweighted GramData's own tensors."""
    jax_fitter, fitter = setup[2]['s_vw']
    ours, theirs = getattr(fitter.gram_w, field), getattr(jax_fitter.gram_w, field)
    if field == 'w_total':
        assert ours == pytest.approx(theirs, rel=1e-12)
        assert fitter.gram.w_total == float(fitter.body_model.num_vertices)
        return
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0)
    if field in ('Msd', 'weights_pad', 'consts_full'):
        assert ours is getattr(fitter.gram, field)


# ---------------------------------------------------------------------------
# Kernel twins against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


def _capture(run):
    calls = {name: [] for name in CAPTURED}
    originals = {name: getattr(port_k, name) for name in CAPTURED}

    def recorder(name):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return wrapped

    try:
        for name in CAPTURED:
            setattr(port_k, name, recorder(name))
        run()
    finally:
        for name in CAPTURED:
            setattr(port_k, name, originals[name])
    return calls


@pytest.fixture(scope='module')
def captured(setup):
    """The weighted wrappers' calls from the port's weighted SMPL paths."""
    _, _, fitters, w, params, tv, tj = setup
    plain, kid = fitters['plain'][1], fitters['kid'][1]
    vw, jw = w['vw'], w['jw']

    def run():
        plain.fit(tv, tj, vertex_weights=vw, joint_weights=jw, num_iter=2)
        plain.fit(tv, vertex_weights=vw, num_iter=2)
        kid.fit(tv, tj, vertex_weights=vw, joint_weights=jw, num_iter=1, scale_target=True)
        plain.fit(tv, vertex_weights=vw, num_iter=1, scale_fit=True)
        plain.fit_with_known_shape(params['betas'], tv, tj, vertex_weights=vw, joint_weights=jw,
                                   num_iter=1)
        fitters['s_both'][1].fit(tv, tj, num_iter=2)
        fitters['s_vw'][1].fit(tv, num_iter=2)
        fitters['s_vw'][1].fit(tv, num_iter=1, scale_fit=True)
        fitters['s_both'][1].fit_with_known_shape(params['betas'], tv, tj, num_iter=1)

    return _capture(run)


def _to_np(x):
    if isinstance(x, port_k.PartIndex):
        return x.pm.numpy()
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _jax_call(name, args, kwargs):
    """The JAX kernel on a port call's operands; K9's segment cover serves
    only the port's kernel."""
    args = [_to_np(a) for a in args]
    kwargs = {k: _to_np(v) for k, v in kwargs.items() if k != 'cover'}
    fn = getattr(jax_k, name)
    return fn(*args, **kwargs, interpret=True)


def _assert_close(ours, theirs):
    assert len(ours) == len(theirs)
    for t, r in zip(ours, theirs):
        t, r = t.numpy(), np.asarray(r)
        assert t.shape == r.shape
        np.testing.assert_allclose(t, r, rtol=0, atol=REL_TOL * np.max(np.abs(r)))


def _assert_wgram_close(args, ours, theirs):
    """K9's outputs. SA sums a Jacobian centred by its own weighted mean and r
    a product with residuals of either sign, so both cancel to far below
    their terms; their limits scale with the Cauchy-Schwarz bounds of the
    terms, sqrt(W G_ee) and sqrt(G_ee sum ω |b|^2)."""
    tgt, pj, homog, _, w, _, _, om = args[:8]
    V = om.shape[0]
    pos = port_k._apply_blend(torch.einsum('vj,xjb->xvb', w[:V], pj), homog[:, :V])
    bb = (((tgt - pos) ** 2).sum(dim=0) * om).sum(dim=0).numpy()  # (B,)
    G, SA, r, Sb, W = (t.numpy() for t in ours)
    E1 = r.shape[0]
    diag = G.reshape(E1, E1, -1)[np.arange(E1), np.arange(E1)]
    scales = dict(SA=np.sqrt(W * diag).max(), r=np.sqrt(diag * bb).max())
    for name, t, ref in zip(('G', 'SA', 'r', 'Sb', 'W'), (G, SA, r, Sb, W), theirs):
        ref = np.asarray(ref)
        assert t.shape == ref.shape, name
        scale = scales.get(name, np.max(np.abs(ref)))
        np.testing.assert_allclose(t, ref, rtol=0, atol=REL_TOL * scale, err_msg=name)


def _pick(calls, **want):
    """The calls whose keyword arguments and operands match ``want``:
    ``scale`` / ``scale_mode`` (values), ``omega`` ('static', 'call') and
    ``bcast`` (a batch-constant reference)."""
    out = []
    for args, kwargs in calls:
        om = kwargs.get('omega', kwargs.get('omega_vm', args[7] if len(args) > 7 else None))
        got = dict(scale=bool(kwargs.get('scale')), scale_mode=kwargs.get('scale_mode', 0),
                   omega=None if om is None else ('static' if om.shape[1] == 1 else 'call'),
                   bcast=args[1].shape[2] == 1)
        if all(got[k] == v for k, v in want.items()):
            out.append((args, kwargs))
    assert out, want
    return out[0]


TWIN_CASES = {
    'wgram_e10': ('wgram_moments', dict(scale_mode=0)),
    'wgram_kid_scale_target': ('wgram_moments', dict(scale_mode=1)),
    'wgram_scale_fit': ('wgram_moments', dict(scale_mode=2)),
    'rhs_moments_h_static': ('rhs_moments_h', dict(omega='static')),
    'rhs_moments_static': ('rhs_moments', dict(omega='static', scale=False)),
    'rhs_moments_scale_static': ('rhs_moments', dict(omega='static', scale=True)),
    'part_sums_call_broadcast': ('part_sums_vm_lm', dict(omega='call', bcast=True)),
    'part_sums_call': ('part_sums_vm_lm', dict(omega='call', bcast=False)),
    'part_sums_static': ('part_sums_vm_lm', dict(omega='static')),
    'recon_part_sums_call': ('recon_part_sums_lm', dict(omega='call')),
    'recon_part_sums_static': ('recon_part_sums_lm', dict(omega='static')),
    'recon_cached_call': ('recon_part_sums_cached_lm', dict(omega='call')),
    'recon_cached_static': ('recon_part_sums_cached_lm', dict(omega='static')),
}


@pytest.mark.parametrize('case', list(TWIN_CASES))
def test_weighted_twin_matches_jax_kernel(captured, case):
    name, want = TWIN_CASES[case]
    args, kwargs = _pick(captured[name], **want)
    ours, theirs = port_k.twin_call(name, args, kwargs), _jax_call(name, args, kwargs)
    if name == 'wgram_moments':
        _assert_wgram_close(args, ours, theirs)
    else:
        _assert_close(ours, theirs)


@pytest.mark.parametrize('scale', [False, True])
def test_cached_rhs_static_omega_twin_matches_jax_kernel(captured, scale):
    """K2's cached forms with ω, on the emit form's operands and its posed template."""
    args, kwargs = _pick(captured['rhs_moments_h'], omega='static')
    tgt, pj, feat, w, consts, sd = args
    homog = port_k.posed_template_ref(feat, consts)
    call = (tgt, pj, homog, w, sd)
    kw = dict(kwargs, scale=scale)
    ours = port_k.rhs_moments_cached(*call, **kw)
    _assert_close(ours, _jax_call('rhs_moments_cached', call, kw))


def test_weighted_paths_reach_the_weighted_forms(captured):
    """Per-call paths never reach K2, static paths never reach K9."""
    assert all('omega' not in kw or kw['omega'].shape[1] == 1
               for name in ('rhs_moments', 'rhs_moments_h') for _, kw in captured[name])
    assert len(captured['wgram_moments']) == 2 + 2 + 1 + 1


def test_wgram_twin_matches_jax_on_smplx(body_models_dir):
    """K9 at SMPL-X's J = 55, V = 660: E = 16, and E = 17 (the kid column)
    with the scale column of ``scale_target``."""
    jax_bm = smplfitter_tpu.BodyModel('smplx', 'neutral')
    bm = port_model_from(jax_bm)
    rng = np.random.default_rng(31)
    pose = rng.normal(0, 0.1, (BATCH, 165)).astype(np.float32)
    betas = rng.normal(0, 1, (BATCH, 16)).astype(np.float32)
    out = bm(pose, betas)
    vw = _weights(rng, BATCH, bm.num_vertices)
    jw = _weights(rng, BATCH, bm.num_joints)
    for enable_kid, scale_mode in ((False, 0), (True, 1)):
        fitter = smplfitter_tpu_torch.BodyFitter(bm, enable_kid=enable_kid)
        calls = _capture(lambda: fitter.fit(out['vertices'], out['joints'], vertex_weights=vw,
                                            joint_weights=jw, num_iter=1,
                                            scale_target=scale_mode == 1))
        args, kwargs = calls['wgram_moments'][0]
        assert args[5].shape[2] == 16 + enable_kid and kwargs['scale_mode'] == scale_mode
        _assert_wgram_close(args, port_k.twin_call('wgram_moments', args, kwargs),
                            _jax_call('wgram_moments', args, kwargs))


# ---------------------------------------------------------------------------
# Fits against the JAX package
# ---------------------------------------------------------------------------

# name -> (fitter, with target joints, weights passed per call, fit keywords);
# 'warm' marks a warm start from perturbed parameters.
FIT_CASES = {
    'call_vw_no_joints': ('plain', False, ('vw',), dict(num_iter=2)),
    'call_vw_jw_joints': ('plain', True, ('vw', 'jw'),
                          dict(num_iter=3, requested_keys=('pose_rotvecs', 'vertices'))),
    'call_vw_only_joints': ('plain', True, ('vw',), dict(num_iter=2)),
    'call_jw_only_joints': ('plain', True, ('jw',), dict(num_iter=2)),
    'call_vw_jw_scale_fit': ('plain', True, ('vw', 'jw'), dict(num_iter=2, scale_fit=True)),
    'call_vw_jw_scale_target': ('plain', True, ('vw', 'jw'),
                                dict(num_iter=2, scale_target=True)),
    'call_vw_warm_start': ('plain', False, ('vw',), dict(num_iter=1, warm=True)),
    'static_vw_no_joints': ('s_vw', False, (), dict(num_iter=2)),
    'static_vw_jw_joints': ('s_both', True, (), dict(num_iter=3)),
    'static_vw_joints': ('s_vw', True, (), dict(num_iter=2, scale_target=True)),
}


def _call_weights(w, which):
    return {dict(vw='vertex_weights', jw='joint_weights')[k]: w[k] for k in which}


@pytest.mark.parametrize('case', list(FIT_CASES))
def test_weighted_fit_matches_jax(setup, case):
    jax_bm, _, fitters, w, params, tv, tj = setup
    fitter_key, with_joints, which, kw = FIT_CASES[case]
    kw = dict(kw, **_call_weights(w, which))
    if kw.pop('warm', False):
        kw.update(initial_pose_rotvecs=params['pose'] + 0.05,
                  initial_shape_betas=params['betas'] + 0.1)
    jax_fitter, fitter = fitters[fitter_key]
    joints = tj if with_joints else None
    _check(jax_bm, fitter.fit(tv, joints, **kw), jax_fitter.fit(tv, joints, **kw), tv)


@pytest.mark.parametrize('fitter_key,with_joints,which', [
    ('plain', True, ('vw', 'jw')), ('plain', False, ('vw',)), ('s_both', True, ())])
def test_weighted_known_pose_matches_jax(setup, fitter_key, with_joints, which):
    jax_bm, _, fitters, w, params, tv, tj = setup
    jax_fitter, fitter = fitters[fitter_key]
    args = (params['pose'], tv, tj if with_joints else None)
    kw = _call_weights(w, which)
    _check(jax_bm, fitter.fit_with_known_pose(*args, **kw),
           jax_fitter.fit_with_known_pose(*args, **kw), tv)


@pytest.mark.parametrize('fitter_key,with_joints,which', [
    ('plain', True, ('vw', 'jw')), ('plain', False, ('vw',)), ('s_both', True, ()),
    ('s_vw', False, ())])
def test_weighted_known_shape_matches_jax(setup, fitter_key, with_joints, which):
    jax_bm, _, fitters, w, params, tv, tj = setup
    jax_fitter, fitter = fitters[fitter_key]
    args = (params['betas'], tv, tj if with_joints else None)
    kw = dict(_call_weights(w, which), num_iter=2, final_adjust_rots=True)
    _check(jax_bm, fitter.fit_with_known_shape(*args, **kw),
           jax_fitter.fit_with_known_shape(*args, **kw), tv)


@pytest.mark.parametrize('scale', [False, True])
def test_weighted_scale_and_translation_matches_jax(setup, scale):
    _, _, fitters, w, _, tv, tj = setup
    rng = np.random.default_rng(5)
    ref_v = (tv * 0.9 + rng.normal(0, 0.01, tv.shape)).astype(np.float32)
    ref_j = (tj * 0.9 + rng.normal(0, 0.01, tj.shape)).astype(np.float32)
    jax_fitter, fitter = fitters['plain']
    for joints, which in (((None, None), ('vw',)), ((tj, ref_j), ('vw', 'jw')),
                          ((tj, ref_j), ('vw',))):
        kw = dict(_call_weights(w, which), scale=scale)
        ours = fitter.fit_scale_and_translation(tv, ref_v, *joints, **kw)
        theirs = jax_fitter.fit_scale_and_translation(tv, ref_v, *joints, **kw)
        assert ours.keys() == theirs.keys()
        for key in ours:
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The port's own static-weight contract and its errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('fitter_key,with_joints', [('s_vw', False), ('s_vw', True),
                                                     ('s_both', True)])
def test_static_fit_equals_broadcast_per_call_fit(setup, fitter_key, with_joints):
    _, bm, fitters, w, _, tv, tj = setup
    fitter, plain = fitters[fitter_key][1], fitters['plain'][1]
    joints = tj if with_joints else None
    kw = dict(num_iter=3, beta_regularizer=0.5,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
    per_call = dict(vertex_weights=np.broadcast_to(w['svw'], (BATCH, bm.num_vertices)).copy())
    if fitter_key == 's_both':
        per_call['joint_weights'] = np.broadcast_to(w['sjw'], (BATCH, bm.num_joints)).copy()
    got, ref = fitter.fit(tv, joints, **kw), plain.fit(tv, joints, **per_call, **kw)
    for key in ('shape_betas', 'trans'):
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), atol=STATIC_TOL,
                                   rtol=STATIC_TOL, err_msg=key)
    np.testing.assert_allclose(got['pose_rotvecs'].numpy(), ref['pose_rotvecs'].numpy(),
                               atol=STATIC_POSE_TOL, rtol=0)


def test_bad_weights_raise(setup):
    _, bm, fitters, w, params, tv, tj = setup
    static, plain = fitters['s_vw'][1], fitters['plain'][1]
    with pytest.raises(ValueError, match='static'):
        static.fit(tv, vertex_weights=w['vw'])
    with pytest.raises(ValueError, match='static'):
        static.fit_with_known_pose(params['pose'], tv, tj, joint_weights=w['jw'])
    with pytest.raises(ValueError, match='static'):
        static.fit_with_known_shape(params['betas'], tv, vertex_weights=w['vw'])
    with pytest.raises(ValueError, match='vertex_weights'):
        smplfitter_tpu_torch.BodyFitter(bm, vertex_weights=np.ones(3, np.float32))
    with pytest.raises(ValueError, match='joint_weights'):
        smplfitter_tpu_torch.BodyFitter(bm, joint_weights=np.ones(3, np.float32))
    with pytest.raises(ValueError, match='vertex_weights'):
        plain.fit(tv, vertex_weights=w['vw'][:, :10])
    with pytest.raises(ValueError, match='joint_weights'):
        plain.fit(tv, tj, joint_weights=w['jw'][:3])
