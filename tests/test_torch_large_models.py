"""SMPL-X, SMPL+H and MANO in the port, against the JAX package on the CPU.

Synthetic models from the suite's body_models directory (tests/conftest.py): SMPL-X (J=55,
F=487, 16 betas, V=660 padded to 768), SMPL+H ``smplh16`` (J=52, F=460, 16
betas, V=432) and MANO (J=16, F=136, 10 betas, V=240). Inputs are made from
numpy seeds and handed to both packages.

- Plan and shape-solve fields must reproduce the JAX builders (the same f64
  host math cast to f32): rtol 1e-6.
- The forward pass: 2e-5 x the output's scale (f32 on both sides, other
  summation orders).
- The twins of the large-model kernels (K7 posed template, K2 cached plain and
  scale, K8 term1, the Gramian's other parts, K4 at E = 17) against the JAX
  kernels in interpret mode, on operands captured from the port's SMPL-X
  fits: 2e-5 x max|JAX output| per output. The JAX kernels and the JAX
  package's ``_gram_mparts_ref`` compute in 3-pass bf16 (about 1.4e-5
  relative), the twins in plain f32.
- Fits: mean reconstruction errors within 0.01 mm of each other (the bench.py
  gate) and, on SMPL-X, betas (and kid factor, scale) within 2e-3, orientations
  within 8e-3 and translations within 3e-4: tighter than, or for orientations
  equal to, the JAX package's own SMPL-X tolerances (tests/test_model_variants.py:
  betas and trans 3e-3, pose 8e-3). Hand parts are nearly degenerate: isolated
  finger joints differ by up to ~6e-3 and the betas by up to ~6e-4 between the
  two packages, and f32 reduction-order noise (another thread count, another
  summation order) moves them by about as much. MANO keeps the bench gate's
  betas (1e-3), orientations within 3e-3 and translations within 1e-4.
"""

from __future__ import annotations

import os.path as osp
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import smplfitter_tpu
import smplfitter_tpu_torch
from port_on_cpu import port_model_from
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu.utils import modeldata as jax_modeldata
from smplfitter_tpu.utils import synthetic as jax_synthetic
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import modeldata as port_modeldata
from smplfitter_tpu_torch.utils import synthetic as port_synthetic

REL_TOL = 2e-5
BATCH = 8
# model -> tolerance of (betas, kid and scale; orientations; translations)
FIT_ATOL = {'smplx': (2e-3, 8e-3, 3e-4), 'mano': (1e-3, 3e-3, 1e-4)}
V2V_MM = 0.01
PLAN_TENSORS = ('part_counts', 'center_matrix', 'mjp_joint_membership', 'mjp_joint_counts',
                'mjp_center_matrix', 'J_template_ext', 'bone_ext', 'pm_t_pad', 'default_mesh_vm')
PLAN_STATIC = ('bone_parts', 'leaf_parts', 'bone_pairs', 'assemble_indices', 'children_and_self',
               'is_smpl_family', 'n_betas', 'enable_kid', 'adj_level_buckets')
GRAM_TENSORS = ('weights_pad', 'consts_pose', 'consts_full', 'sd_cm', 'Ksd', 'Lz_e', 'sd1_2d',
                'q', 'W1_col', 'Kc')
# model -> (joints, pose-template width F, betas)
SHAPES = {'smplx': (55, 487, 16), 'smplh16': (52, 460, 16), 'mano': (16, 136, 10)}


@pytest.fixture(scope='module')
def models(body_models_dir):
    """Both packages' models and fitters (without and with the kid column) by name."""
    jax_synthetic.write_model_files(body_models_dir, 'mano', num_vertices=240, num_betas=10)
    out = {}
    for name in SHAPES:
        jax_bm = smplfitter_tpu.BodyModel(name, 'neutral')
        bm = port_model_from(jax_bm)
        kids = (False, True) if name == 'smplx' else (False,)
        out[name] = (jax_bm, bm, {kid: (smplfitter_tpu.BodyFitter(jax_bm, enable_kid=kid),
                                        smplfitter_tpu_torch.BodyFitter(bm, enable_kid=kid))
                                  for kid in kids})
    return out


def _params(name, seed, batch=BATCH):
    J, _, S = SHAPES[name]
    rng = np.random.default_rng(seed)
    return dict(pose=rng.normal(0, 0.1, (batch, 3 * J)).astype(np.float32),
                betas=rng.normal(0, 1, (batch, S)).astype(np.float32),
                trans=rng.normal(0, 0.3, (batch, 3)).astype(np.float32),
                kid=rng.normal(0, 0.3, (batch,)).astype(np.float32))


def _np(x):
    if isinstance(x, port_k.PartIndex):
        return x.pm.numpy()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rel=REL_TOL):
    ours, theirs = _np(ours), _np(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=rel * max(np.max(np.abs(theirs)), 1e-30))


# ---------------------------------------------------------------------------
# The device default
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card(models, monkeypatch):
    """Without CUDA and without device='cpu' the model raises; it never falls
    back to the CPU. With device='cpu' it and its fitter stay on the CPU."""
    jax_bm, bm, fitters = models['mano']
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smplfitter_tpu_torch.BodyModel('mano', 'neutral')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smplfitter_tpu_torch.BodyModel.from_model_data(jax_bm.model_data, 'mano')
    fitter = fitters[False][1]
    assert bm.device.type == 'cpu'
    assert all(t.device.type == 'cpu' for t in fitter.buffers())


# ---------------------------------------------------------------------------
# Host-side structures
# ---------------------------------------------------------------------------


def _load_raw(path):
    if path.endswith('.npz'):
        return dict(np.load(path))
    with open(path, 'rb') as f:
        return pickle.load(f)


@pytest.mark.parametrize('name', list(SHAPES))
def test_synthetic_writer_matches_original(tmp_path, name):
    """The copied writer produces the JAX package's files for each skeleton."""
    S = SHAPES[name][2]
    ours = port_synthetic.write_model_files(str(tmp_path / 'ours'), name, 300, S, seed=3)
    theirs = jax_synthetic.write_model_files(str(tmp_path / 'theirs'), name, 300, S, seed=3)
    assert port_synthetic.skeleton(name)[0] == jax_synthetic.skeleton(name)[0]
    filename = jax_modeldata.model_filename(name, 'neutral')
    raw_ours = _load_raw(osp.join(ours, filename))
    raw_theirs = _load_raw(osp.join(theirs, filename))
    assert raw_ours.keys() == raw_theirs.keys()
    for key in raw_ours:
        np.testing.assert_array_equal(raw_ours[key], raw_theirs[key], err_msg=key)
    assert osp.exists(osp.join(ours, 'kid_template.npy')) == (name != 'mano')


@pytest.mark.parametrize('name', list(SHAPES))
def test_loader_copy_matches_original(models, name):
    """The copied loader reads npz (SMPL-X, SMPL+H) and pickle (MANO) files,
    with and without a kid template, into the JAX loader's arrays."""
    ours = port_modeldata.initialize(name, 'neutral')
    theirs = jax_modeldata.initialize(name, 'neutral')
    for field in ('v_template', 'shapedirs', 'posedirs', 'J_regressor_post_lbs', 'J_template',
                  'J_shapedirs', 'kid_shapedir', 'kid_J_shapedir', 'weights', 'faces'):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field),
                                      err_msg=field)
    assert ours.kintree_parents == theirs.kintree_parents
    assert ours.joint_names == theirs.joint_names
    assert port_modeldata.model_filename(name, 'neutral') == jax_modeldata.model_filename(
        name, 'neutral')


def test_ensure_cached_models_writes_every_model(tmp_path):
    d = port_synthetic.ensure_cached_models(str(tmp_path / 'cache'), 200, 300)
    for name, V in (('smpl', 200), ('smplx', 300), ('smplh16', 200), ('mano', 778)):
        data = port_modeldata.initialize(name, 'neutral', osp.join(d, name))
        assert data.num_vertices == V
        assert data.shapedirs.shape[2] == (16 if name in ('smplx', 'smplh16') else 10)


def test_model_shapes(models):
    for name, (J, F, S) in SHAPES.items():
        bm = models[name][1]
        assert (bm.num_joints, bm.num_betas) == (J, S)
        assert bm.posedirs.shape[2] + 1 == F
        assert models[name][2][False][1].gram.consts_pose.shape[2] == F
    assert models['mano'][1].joint_names[0] == 'wrist'


@pytest.mark.parametrize('case', ['smplx', 'smplx_kid', 'smplh16', 'mano'])
def test_plan_fields_match_jax(models, case):
    name = case.removesuffix('_kid')
    jax_fitter, fitter = models[name][2][case.endswith('_kid')]
    jax_plan, plan = jax_fitter.plan, fitter.plan
    assert jax_plan.vperm is None  # canonical vertex order on both sides
    for field in PLAN_STATIC:
        assert getattr(plan, field) == getattr(jax_plan, field), field
    for field in PLAN_TENSORS:
        np.testing.assert_allclose(_np(getattr(plan, field)), _np(getattr(jax_plan, field)),
                                   rtol=1e-6, atol=0, err_msg=field)
    assert sorted(plan.parts.verts.tolist()) == list(jax_plan.used_vertex_indices)


def test_mano_plan_adjusts_every_part(models):
    """MANO is not SMPL-family: every part is adjustable, scheduled root first
    and then per tree level in buckets of equal joint count."""
    plan = models['mano'][2][False][1].plan
    assert not plan.is_smpl_family
    buckets = plan.adj_level_buckets
    assert buckets[0] == ((0,),)
    assert sorted(i for entry in buckets for bucket in entry for i in bucket) == list(range(16))
    for entry in buckets:
        for bucket in entry:
            assert len({len(plan.children_and_self[i]) for i in bucket}) == 1


@pytest.mark.parametrize('case', ['smplx', 'smplx_kid', 'smplh16', 'mano'])
def test_gram_fields_match_jax(models, case):
    name = case.removesuffix('_kid')
    kid = case.endswith('_kid')
    jax_fitter, fitter = models[name][2][kid]
    jax_gram, gram = jax_fitter.gram, fitter.gram
    assert jax_gram.vperm is None
    assert gram.n_ext == jax_gram.n_ext == SHAPES[name][2] + kid
    for field in GRAM_TENSORS:
        np.testing.assert_allclose(_np(getattr(gram, field)), _np(getattr(jax_gram, field)),
                                   rtol=1e-6, atol=0, err_msg=field)


@pytest.mark.parametrize('name,kid,streamed', [
    ('smpl', False, False), ('smpl', True, False), ('mano', False, False),
    ('smplh16', False, True), ('smplx', False, True), ('smplx', True, True)])
def test_routes_follow_the_jax_switches(models, name, kid, streamed):
    """The Gramian streams term1 (K8) exactly where the JAX package does
    (_gram_xblock), and the solve caches the posed template (K7) exactly for
    F > HOMOG_GEMM_MIN_F, the JAX package's bound."""
    J, F, S = SHAPES.get(name, (24, 208, 10))
    E = S + kid
    assert port_k.streams_term1(3 * J, E) == streamed
    assert (jax_k._gram_xblock(3 * J, E) is not None) == streamed
    assert port_k.HOMOG_GEMM_MIN_F == jax_k.HOMOG_GEMM_MIN_F
    assert (F > port_k.HOMOG_GEMM_MIN_F) == streamed


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('name', list(SHAPES))
def test_forward_matches_jax(models, name):
    jax_bm, bm, _ = models[name]
    p = _params(name, seed=5, batch=4)
    kid = p['kid'] if name != 'mano' else None
    ours = bm(p['pose'], p['betas'], p['trans'], kid)
    theirs = jax_bm(p['pose'], p['betas'], p['trans'], kid)
    assert set(ours) == set(theirs)
    for key in ours:
        _close(ours[key], theirs[key])


# ---------------------------------------------------------------------------
# Kernel twins against the JAX kernels
# ---------------------------------------------------------------------------

CAPTURED = ('posed_template_lm', 'rhs_moments_cached', 'term1', 'gram_mparts_ref',
            'recon_part_sums_cached_lm', 'gram_assembly', 'rhs_moments_h', 'rhs_moments')


@pytest.fixture(scope='module')
def captured(models):
    """The large-model wrappers' calls from the port's SMPL-X fits at B=8:
    the headline fit (E = 16), a fit with the kid column and joints (E = 17)
    and a scale fit."""
    jax_bm, bm, fitters = models['smplx']
    p = _params('smplx', seed=7)
    out = bm(p['pose'], p['betas'], p['trans'], p['kid'])
    tv, tj = out['vertices'], out['joints']
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
        fitters[False][1].fit(tv, tj, num_iter=3, beta_regularizer=1.0, final_adjust_rots=True)
        n_headline = {name: len(c) for name, c in calls.items()}
        fitters[True][1].fit(tv, tj, num_iter=1, final_adjust_rots=True)
        fitters[False][1].fit(tv, tj, num_iter=1, scale_fit=True, final_adjust_rots=False)
    finally:
        for name in CAPTURED:
            setattr(port_k, name, originals[name])
    return calls, n_headline


def test_smplx_fit_takes_the_large_model_route(captured):
    """Per solve: K7, then K2's cached form, then the Gramian by K8 and the
    tensor-op parts; the rotation fits read the cache through K4. The
    in-kernel homog forms of K2 never run, and K3 never launches (the
    gram_assembly wrapper streams: it is called, its kernel is not)."""
    calls, n_headline = captured
    assert n_headline == dict(posed_template_lm=3, rhs_moments_cached=3, term1=3,
                              gram_mparts_ref=3, recon_part_sums_cached_lm=3, gram_assembly=3,
                              rhs_moments_h=0, rhs_moments=0)
    assert [kw.get('scale', False) for _, kw in calls['rhs_moments_cached']] == [False] * 4 + [True]
    assert [c[0][2].shape[0] for c in calls['recon_part_sums_cached_lm']] == [16] * 3 + [17]


def _pick(calls, name, E=16, scale=False):
    """The first captured call of a wrapper at E shape columns (and form)."""
    for args, kwargs in calls[name]:
        if name == 'posed_template_lm':
            return args, kwargs
        e = {'rhs_moments_cached': lambda a: a[4].shape[2],
             'term1': lambda a: int(round(a[1].shape[1] ** 0.5)),
             'gram_mparts_ref': lambda a: a[6].shape[1],
             'recon_part_sums_cached_lm': lambda a: a[2].shape[0]}[name](args)
        if e == E and kwargs.get('scale', False) == scale:
            return args, kwargs
    raise AssertionError(f'no captured {name} call at E={E}, scale={scale}')


@pytest.mark.parametrize('form', [
    'posed_template', 'rhs_moments_cached', 'rhs_moments_cached_kid',
    'rhs_moments_cached_scale', 'term1', 'term1_kid', 'gram_mparts', 'gram_mparts_kid',
    'recon_part_sums_cached_kid'])
def test_twin_matches_jax_kernel(captured, form):
    calls = captured[0]
    E = 17 if form.endswith('_kid') else 16
    scale = form.endswith('_scale')
    name = form.removesuffix('_kid').removesuffix('_scale')
    if name == 'posed_template':
        (feat, consts), _ = _pick(calls, 'posed_template_lm')
        ours = (port_k.posed_template_ref(feat, consts),)
        theirs = (jax_k.posed_template_lm(_np(feat), _np(consts), True),)
    elif name == 'rhs_moments_cached':
        args, kw = _pick(calls, name, E, scale)
        ours = port_k.twin_call(name, args, kw)
        theirs = jax_k.rhs_moments_cached(*map(_np, args), scale=scale, interpret=True)
    elif name == 'term1':
        (R, ksd), _ = _pick(calls, name, E)
        ours = (port_k.term1_ref(R, ksd),)
        xb = jax_k._gram_xblock(R.shape[1], E)
        theirs = (jax_k._term1_blocked(_np(R), _np(ksd), E, R.shape[2], xb, True),)
    elif name == 'gram_mparts':
        args, _ = _pick(calls, 'gram_mparts_ref', E)
        ours = port_k.gram_mparts_ref(*args)
        theirs = jax_k._gram_mparts_ref(*map(_np, args[:-1]), args[-1])
    else:
        args, kw = _pick(calls, 'recon_part_sums_cached_lm', E)
        ours = port_k.twin_call('recon_part_sums_cached_lm', args, kw)
        theirs = jax_k.recon_part_sums_cached_lm(*map(_np, args), interpret=True)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_streamed_gram_matches_the_fused_statement(captured):
    """K8's route (term1 + the other parts) is the math of the fused twin."""
    args, kw = captured[0]['gram_assembly'][0]
    for o, t in zip(port_k.gram_assembly(*args, **kw), port_k.gram_assembly_ref(*args, **kw)):
        _close(o, t, rel=1e-5)


@pytest.mark.parametrize('name', ['posed_template_lm', 'rhs_moments_cached', 'term1'])
def test_new_wrappers_dispatch_cpu_tensors_to_twins(captured, name):
    """On CPU tensors each new wrapper returns its twin's result and launches nothing."""
    port_k.reset_launch_counts()
    args, kwargs = captured[0][name][-1]
    got = getattr(port_k, name)(*args, **kwargs)
    got = got if isinstance(got, tuple) else (got,)
    for g, t in zip(got, port_k.twin_call(name, args, kwargs), strict=True):
        assert torch.equal(g, t) and g.is_contiguous()
    assert all(n == 0 for n in port_k.LAUNCHES.values())


@pytest.mark.parametrize('name', ['posed_template_lm', 'rhs_moments_cached', 'term1'])
def test_new_wrappers_reject_bad_operands(captured, name):
    """A template of the wrong width, a cache of the wrong batch, a Ksd of
    the wrong row count."""
    args, kwargs = captured[0][name][0]
    args = list(args)
    if name == 'posed_template_lm':
        args[1] = args[1][:, :, 1:].contiguous()
    elif name == 'rhs_moments_cached':
        args[2] = args[2][:, :, 1:].contiguous()
    else:
        args[1] = args[1][1:].contiguous()
    with pytest.raises(ValueError):
        getattr(port_k, name)(*args, **kwargs)


@pytest.mark.parametrize('J3, E, B, splits', [
    (165, 16, 4096, 4), (156, 16, 4096, 4), (165, 17, 4096, 2), (165, 16, 1000, 16),
    (165, 16, 1, 132), (72, 32, 4096, 1), (3, 16, 1, 1)])
def test_term1_splits_fill_one_wave(monkeypatch, J3, E, B, splits):
    """K8 splits its J3^2 sum so that its (256-row, 128-column) tiles fill one
    wave of a 132-SM card, one block per SM, with at most one split per k
    stage of 8 k by 5 j values."""
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: SimpleNamespace(multi_processor_count=132))
    assert port_k.term1_splits(J3, E * E, B, 'cuda') == splits


# ---------------------------------------------------------------------------
# Fits against the JAX package
# ---------------------------------------------------------------------------


def _recon_v2v_mm(jax_bm, res, tv):
    kid = res.get('kid_factor')
    re = jax_bm(glob_rotmats=_np(res['orientations']), shape_betas=_np(res['shape_betas']),
                trans=_np(res['trans']), kid_factor=None if kid is None else _np(kid))
    return float(np.mean(np.linalg.norm(np.asarray(re['vertices']) - tv, axis=-1)) * 1e3)


def _check(jax_bm, ours, theirs, tv, model):
    param_atol, rot_atol, trans_atol = FIT_ATOL[model]
    for key, value in theirs.items():
        assert key in ours, key
        assert tuple(ours[key].shape) == tuple(np.shape(value)), key
        assert torch.isfinite(ours[key]).all(), key
    for key in ('shape_betas', 'kid_factor', 'scale_corr'):
        if key in theirs:
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=param_atol,
                                       rtol=0, err_msg=key)
    for key in ('orientations', 'relative_orientations'):
        if key in theirs:
            np.testing.assert_allclose(_np(ours[key]), _np(theirs[key]), atol=rot_atol, rtol=0,
                                       err_msg=key)
    np.testing.assert_allclose(_np(ours['trans']), _np(theirs['trans']), atol=trans_atol, rtol=0)
    assert abs(_recon_v2v_mm(jax_bm, ours, tv) - _recon_v2v_mm(jax_bm, theirs, tv)) <= V2V_MM


# name -> (model, enable_kid, with target joints, the call on (fitter, params, tv, tj))
FIT_CASES = {
    'smplx_headline': ('smplx', False, lambda f, p, tv, tj: f.fit(
        tv, tj, num_iter=3, beta_regularizer=1.0, final_adjust_rots=True,
        requested_keys=('pose_rotvecs', 'shape_betas', 'trans')), True),
    'smplx_scale_fit_joints': ('smplx', False, lambda f, p, tv, tj: f.fit(
        tv, tj, num_iter=2, scale_fit=True, final_adjust_rots=True), True),
    'smplx_flipper_kid_warm_start': ('smplx', True, lambda f, p, tv, tj: f.fit(
        tv, num_iter=1, final_adjust_rots=True, beta_regularizer=1e-2, beta_regularizer2=1e-2,
        kid_regularizer=1e9, initial_pose_rotvecs=p['pose'] + 0.05,
        initial_shape_betas=p['betas'] + 0.1, initial_kid_factor=p['kid'] + 0.1), False),
    'smplx_known_pose_no_joints': ('smplx', True, lambda f, p, tv, tj: f.fit_with_known_pose(
        p['pose'], tv), False),
    'smplx_known_shape_joints': ('smplx', False, lambda f, p, tv, tj: f.fit_with_known_shape(
        p['betas'], tv, tj, num_iter=2, final_adjust_rots=True), True),
    'mano_headline': ('mano', False, lambda f, p, tv, tj: f.fit(
        tv, tj, num_iter=3, beta_regularizer=1.0, final_adjust_rots=True,
        requested_keys=('pose_rotvecs', 'shape_betas', 'trans')), True),
}


@pytest.mark.parametrize('case', list(FIT_CASES))
def test_fit_matches_jax(models, case):
    name, kid, run, _ = FIT_CASES[case]
    jax_bm, bm, fitters = models[name]
    p = _params(name, seed=11)
    kid_in = p['kid'] if name != 'mano' else None
    out = jax_bm(p['pose'], p['betas'], p['trans'], kid_in)
    tv, tj = np.array(out['vertices']), np.array(out['joints'])
    jax_fitter, fitter = fitters[kid]
    _check(jax_bm, run(fitter, p, tv, tj), run(jax_fitter, p, tv, tj), tv, name)
