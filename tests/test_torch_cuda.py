"""Card tests of the PyTorch port: each CUDA kernel against its plain twin on
the operands of the fitting paths, the launch counts of a fit with and without
target joints, and a fit on the card against the same fit on the CPU.

Marked ``cuda``; they skip where PyTorch sees no CUDA device. This file imports
no JAX, so on a machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smplfitter_tpu_torch import BodyFitter, BodyModel
from smplfitter_tpu_torch.ops import lbs_kernels
from smplfitter_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

REL_TOL = 1e-5  # max |kernel - twin| / max |twin|: f32 sums in another order
FIT_KW = dict(num_iter=3, beta_regularizer=1.0, final_adjust_rots=True,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
WRAPPERS = ('lbs_points', 'rhs_moments_h', 'gram_assembly', 'recon_part_sums_cached_lm')


@pytest.fixture(scope='module')
def card_models(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    d = str(tmp_path_factory.mktemp('body_models'))
    synthetic.write_model_files(d, 'smpl', 1000)
    bm = BodyModel('smpl', 'neutral', model_root=d + '/smpl', device='cuda')
    return bm, BodyFitter(bm)


@pytest.fixture(scope='module')
def kid_fitter(card_models):
    return BodyFitter(card_models[0], enable_kid=True)


def _params(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.3, (batch, 72)).astype(np.float32),
            rng.normal(0, 1, (batch, 10)).astype(np.float32),
            rng.normal(0, 0.5, (batch, 3)).astype(np.float32))


def _capture(bm, fitter, batch):
    calls = {name: [] for name in WRAPPERS}
    originals = {name: getattr(lbs_kernels, name) for name in WRAPPERS}

    def recorder(name):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return wrapped

    try:
        for name in WRAPPERS:
            setattr(lbs_kernels, name, recorder(name))
        out = bm(*_params(batch, batch))
        fitter.fit(out['vertices'], out['joints'], **FIT_KW)
    finally:
        for name in WRAPPERS:
            setattr(lbs_kernels, name, originals[name])
    return calls


def _check_against_twin(name, calls):
    for args, kwargs in calls:
        got = getattr(lbs_kernels, name)(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = lbs_kernels.twin_call(name, args, kwargs)
        assert len(got) == len(want)
        for g, t in zip(got, want):
            torch.cuda.synchronize()
            assert g.shape == t.shape and g.is_cuda
            assert torch.isfinite(g).all()
            assert (g - t).abs().max().item() <= REL_TOL * t.abs().max().item()


@pytest.mark.parametrize('batch', [64, 37])
@pytest.mark.parametrize('name', WRAPPERS)
def test_kernel_matches_twin(card_models, name, batch):
    calls = _capture(*card_models, batch)[name]
    assert len(calls) == (1 if name == 'lbs_points' else 3)
    _check_against_twin(name, calls)


PATH_WRAPPERS = ('lbs_points', 'rhs_moments', 'gram_assembly', 'part_sums_vm_lm',
                 'recon_part_sums_lm')


def _capture_paths(bm, fitter, kid_fitter, batch):
    """The wrappers' arguments from the fits without joints (plain and the
    flipper's configuration with the kid column), the known-shape fit and the
    scale fit."""
    calls = {name: [] for name in PATH_WRAPPERS}
    originals = {name: getattr(lbs_kernels, name) for name in PATH_WRAPPERS}

    def recorder(name):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return wrapped

    pose, betas, trans = _params(batch, batch + 1)
    kid = np.random.default_rng(batch).normal(0, 0.5, batch).astype(np.float32)
    out = bm(pose, betas, trans, kid)
    tv, tj = out['vertices'], out['joints']
    try:
        for name in PATH_WRAPPERS:
            setattr(lbs_kernels, name, recorder(name))
        fitter.fit(tv, num_iter=2, requested_keys=('vertices',))
        kid_fitter.fit(tv, initial_pose_rotvecs=pose, initial_shape_betas=betas,
                       initial_kid_factor=kid, beta_regularizer=1e-2)
        fitter.fit_with_known_shape(betas, tv, tj, num_iter=2)
        fitter.fit(tv, tj, num_iter=2, scale_fit=True)
    finally:
        for name in PATH_WRAPPERS:
            setattr(lbs_kernels, name, originals[name])
    return calls


@pytest.mark.parametrize('batch', [64, 37])
@pytest.mark.parametrize('name', PATH_WRAPPERS + ('rhs_moments_scale',))
def test_path_kernel_matches_twin(card_models, kid_fitter, name, batch):
    wrapper = 'rhs_moments' if name == 'rhs_moments_scale' else name
    calls = _capture_paths(*card_models, kid_fitter, batch)[wrapper]
    if wrapper == 'rhs_moments':
        calls = [c for c in calls if c[1].get('scale', False) == (name == 'rhs_moments_scale')]
    assert calls, f'{name} was not called on the paths'
    _check_against_twin(wrapper, calls)


def test_fit_launches_each_kernel_three_times(card_models):
    bm, fitter = card_models
    out = bm(*_params(40, 1))
    lbs_kernels.reset_launch_counts()
    fitter.fit(out['vertices'], out['joints'], **FIT_KW)
    assert lbs_kernels.LAUNCHES == dict(
        lbs_points=0, rhs_moments_h=3, rhs_moments=0, rhs_moments_scale=0, gram_assembly=3,
        recon_part_sums_cached=3, part_sums=0, recon_part_sums=0)


def test_fit_without_joints_launch_counts(card_models):
    bm, fitter = card_models
    out = bm(*_params(40, 3))
    lbs_kernels.reset_launch_counts()
    fitter.fit(out['vertices'], num_iter=3, final_adjust_rots=True,
               requested_keys=('pose_rotvecs', 'vertices'))
    assert lbs_kernels.LAUNCHES == dict(
        lbs_points=4, rhs_moments_h=0, rhs_moments=3, rhs_moments_scale=0, gram_assembly=3,
        recon_part_sums_cached=0, part_sums=3, recon_part_sums=0)


def test_card_fit_matches_cpu_fit(card_models):
    bm, fitter = card_models
    out = bm(*_params(16, 2))
    tv, tj = out['vertices'], out['joints']
    card = fitter.fit(tv, tj, **FIT_KW)
    cpu = BodyFitter(BodyModel.from_model_data(bm.model_data)).fit(tv.cpu(), tj.cpu(), **FIT_KW)
    assert (card['shape_betas'].cpu() - cpu['shape_betas']).abs().max().item() <= 1e-3
    for key in ('pose_rotvecs', 'trans'):
        assert torch.allclose(card[key].cpu(), cpu[key], atol=1e-3), key
