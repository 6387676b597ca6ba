"""The twins of K5, K6 and K2's plain and scale forms against the JAX package's
Pallas kernels, and the BodyModel's other inputs and entry points against the
JAX BodyModel.

The kernel operands are captured from the port's own fitting paths on the
synthetic SMPL model (V=432, padded to 512) on the CPU, where every wrapper
runs its twin: a fit without target joints (K2 plain, K5), the flipper's
configuration with the kid column (E = 11), a known-shape fit with joints (K6)
and a scale fit (K2 scale). The same operands go through the JAX kernel API in
interpret mode, as tests/test_pallas_kernels.py runs it. Tolerance: 2e-5 x
max|JAX output| per output, as in tests/test_torch_kernels.py (the JAX kernels
split each f32 dot into bf16 parts; the twins are plain f32).

The forward pass with rotation matrices, the joints-only exit, ``single`` and
``rototranslate`` are held to the JAX BodyModel within 2e-5 x the output's
scale (f32 on both sides, other summation orders).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from smplfitter_tpu import BodyModel as JaxBodyModel
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu.ops import rotation as jax_rot
from port_on_cpu import port_model_from
from smplfitter_tpu_torch import BodyFitter
from smplfitter_tpu_torch.ops import lbs_kernels as port_k

REL_TOL = 2e-5
BATCH = 8
WRAPPERS = ('rhs_moments', 'part_sums_vm_lm', 'recon_part_sums_lm')


@pytest.fixture(scope='module')
def models(body_models_dir):
    jax_bm = JaxBodyModel('smpl', 'neutral')
    bm = port_model_from(jax_bm)
    return jax_bm, bm


@pytest.fixture(scope='module')
def captured(models):
    """Each new wrapper's calls from the port's fitting paths at B=8."""
    bm = models[1]
    rng = np.random.default_rng(4)
    pose = rng.normal(0, 0.3, (BATCH, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (BATCH, 10)).astype(np.float32)
    trans = rng.normal(0, 0.5, (BATCH, 3)).astype(np.float32)
    kid = rng.normal(0, 0.5, (BATCH,)).astype(np.float32)
    calls = {name: [] for name in WRAPPERS}
    originals = {name: getattr(port_k, name) for name in WRAPPERS}

    def recorder(name):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return wrapped

    out = bm(pose, betas, trans, kid)
    tv, tj = out['vertices'], out['joints']
    fitter = BodyFitter(bm)
    try:
        for name in WRAPPERS:
            setattr(port_k, name, recorder(name))
        fitter.fit(tv, num_iter=2)
        BodyFitter(bm, enable_kid=True).fit(tv, initial_pose_rotvecs=pose + 0.05,
                                            initial_shape_betas=betas, initial_kid_factor=kid)
        fitter.fit_with_known_shape(betas, tv, tj, num_iter=1)
        fitter.fit(tv, tj, num_iter=1, scale_fit=True)
    finally:
        for name in WRAPPERS:
            setattr(port_k, name, originals[name])
    return calls


def _np(x):
    return x.pm.numpy() if isinstance(x, port_k.PartIndex) else (
        x.numpy() if isinstance(x, torch.Tensor) else x)


def _jax_call(name, args, kwargs):
    args = [_np(a) for a in args]
    if name == 'rhs_moments':
        return jax_k.rhs_moments(*args, scale=kwargs.get('scale', False), interpret=True)
    if name == 'part_sums_vm_lm':
        return jax_k.part_sums_vm_lm(*args, interpret=True)
    return jax_k.recon_part_sums_lm(*args, interpret=True)


def _assert_close(ours, theirs):
    assert len(ours) == len(theirs)
    for t, r in zip(ours, theirs):
        t, r = t.numpy(), np.asarray(r)
        assert t.shape == r.shape
        np.testing.assert_allclose(t, r, rtol=0, atol=REL_TOL * np.max(np.abs(r)))


@pytest.mark.parametrize('form', [
    'rhs_moments', 'rhs_moments_scale', 'rhs_moments_kid', 'part_sums_vm_lm',
    'part_sums_vm_lm_kid', 'recon_part_sums_lm', 'recon_part_sums_lm_scale_fit',
])
def test_twin_matches_jax_kernel(captured, form):
    """One captured call per form: K2 plain (E = 10 and, from the flipper's
    configuration, E = 11) and scale, K5 against the solve's mesh and the warm
    start's kid mesh, K6 in the known-shape fit and in the scale fit's final
    adjustment."""
    name = form.removesuffix('_scale').removesuffix('_kid').removesuffix('_scale_fit')
    calls = captured[name]
    if name == 'rhs_moments':
        calls = [c for c in calls if c[1].get('scale', False) == form.endswith('_scale')]
    pick = {'rhs_moments_kid': -1, 'part_sums_vm_lm_kid': 2,
            'recon_part_sums_lm_scale_fit': -1}.get(form, 0)
    if form == 'rhs_moments_kid':
        calls = [c for c in calls if c[0][5].shape[2] == 11]
    args, kwargs = calls[pick]
    _assert_close(port_k.twin_call(name, args, kwargs), _jax_call(name, args, kwargs))


def test_paths_call_the_new_wrappers(captured):
    """K2 plain 2 (+1 kid), scale 1; K5 2 (+2 warm start, final adjustment);
    K6 1 + 1 (known shape) + 1 (the scale fit's final adjustment)."""
    counts = {name: len(calls) for name, calls in captured.items()}
    assert counts == dict(rhs_moments=4, part_sums_vm_lm=4, recon_part_sums_lm=3)
    assert sum(bool(c[1].get('scale')) for c in captured['rhs_moments']) == 1


@pytest.mark.parametrize('name', WRAPPERS)
def test_new_wrappers_dispatch_cpu_tensors_to_twins(captured, name):
    """On CPU tensors each wrapper returns its twin's result and launches nothing."""
    port_k.reset_launch_counts()
    for args, kwargs in captured[name]:
        got = getattr(port_k, name)(*args, **kwargs)
        for g, t in zip(got, port_k.twin_call(name, args, kwargs), strict=True):
            assert torch.equal(g, t) and g.is_contiguous()
    assert all(n == 0 for n in port_k.LAUNCHES.values())


@pytest.mark.parametrize('name', WRAPPERS)
def test_new_wrappers_reject_bad_operands(captured, name):
    """A reference with neither one column nor the batch's for K5 (it takes
    per-instance or batch-constant meshes), a template projector of the
    wrong width for K6, too many target rows for K2."""
    args, kwargs = captured[name][0]
    args = list(args)
    if name == 'part_sums_vm_lm':
        assert args[1].shape[2] > 2
        args[1] = args[1][:, :, :2].contiguous()
    elif name == 'recon_part_sums_lm':
        args[4] = args[4][:, :, 1:].contiguous()
    else:
        args[0] = torch.cat([args[0], args[0]], dim=1)
    with pytest.raises(ValueError):
        getattr(port_k, name)(*args, **kwargs)


def _params(seed, batch=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.3, (batch, 72)).astype(np.float32),
            rng.normal(0, 1, (batch, 10)).astype(np.float32),
            rng.normal(0, 0.5, (batch, 3)).astype(np.float32),
            rng.normal(0, 0.5, (batch,)).astype(np.float32))


def _assert_outputs_close(ours, theirs):
    assert ours.keys() == theirs.keys()
    for key in theirs:
        r = np.asarray(theirs[key])
        assert tuple(ours[key].shape) == r.shape, key
        np.testing.assert_allclose(ours[key].numpy(), r, rtol=0,
                                   atol=REL_TOL * max(np.max(np.abs(r)), 1.0), err_msg=key)


@pytest.mark.parametrize('rot_input', ['rel_rotmats', 'glob_rotmats'])
def test_forward_with_rotation_matrices_matches_jax(models, rot_input):
    jax_bm, bm = models
    pose, betas, trans, kid = _params(1)
    if rot_input == 'glob_rotmats':
        rots = np.asarray(jax_bm(pose, return_vertices=False)['orientations'])
    else:
        rots = np.asarray(jax_rot.rotvec2mat(pose.reshape(-1, 24, 3)))
    kw = {rot_input: rots}
    _assert_outputs_close(bm(shape_betas=betas, trans=trans, kid_factor=kid, **kw),
                          jax_bm(shape_betas=betas, trans=trans, kid_factor=kid, **kw))
    with pytest.raises(ValueError, match='Only one rotation input'):
        bm(pose_rotvecs=pose, **kw)


def test_forward_joints_only_matches_jax(models):
    jax_bm, bm = models
    pose, betas, trans, _ = _params(2)
    ours = bm(pose, betas, trans, return_vertices=False)
    assert set(ours) == {'joints', 'orientations'}
    _assert_outputs_close(ours, jax_bm(pose, betas, trans, return_vertices=False))


def test_single_matches_jax(models):
    jax_bm, bm = models
    pose, betas, trans, _ = _params(3, batch=1)
    _assert_outputs_close(bm.single(pose[0], betas[0], trans[0]),
                          jax_bm.single(pose[0], betas[0], trans[0]))
    _assert_outputs_close(bm.single(), jax_bm.single())


@pytest.mark.parametrize('post_translate', [True, False])
def test_rototranslate_matches_jax(models, post_translate):
    jax_bm, bm = models
    pose, betas, trans, _ = _params(4, batch=1)
    R = Rotation.from_rotvec([0.3, -0.5, 0.2]).as_matrix().astype(np.float32)
    t = np.array([0.1, -0.2, 0.3], np.float32)
    kw = dict(pose_rotvecs=pose[0], shape_betas=betas[0], trans=trans[0], kid_factor=0.4,
              post_translate=post_translate)
    ours = bm.rototranslate(R, t, **kw)
    theirs = jax_bm.rototranslate(R, t, **kw)
    for o, r in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=2e-6)
