"""Card tests of the PyTorch port: each CUDA kernel against its plain twin on
the operands of the fitting paths (SMPL and SMPL-X), the launch counts of a
fit with and without target joints and of an SMPL-X fit, and fits on the card
against the same fits on the CPU, unweighted and with fit weights (per call
and static: K9 and the ω forms of K2, K4, K5 and K6); the backward kernels
K10-K15 against their twins, the launches and torch-op backward passes of
every gradient path, and gradients on the card against the CPU; the GEMM
kernels K7 and K8 on seeded operands at the shapes whose edges they mask,
against their twins and bit for bit against a second call; the kernels that
walk active-joint lists (K9, K6, K1, K2, K4 in its three forms, and the
backward kernels K10, K13 and K14 at MANO, SMPL and SMPL-X widths) the same
way, and K11 and K12 (every form, unweighted and static ω) over K2's
cover at MANO, SMPL and SMPL-X widths and dense SMPL-X weights; K2's
template-dot forms on runs long enough for its overlapped loop (odd runs,
E = 11 and 32, ω, dense weights, the 4-byte path) and at B = 32 on its
serial loop, with ``K2_PIPELINE``'s count of each; K3 at SMPL
and MANO widths with and without the joints block, and K15 in every form
over a part index with rows in no part; ``share_beta`` and the ragged fit
function on the card against the CPU; and every kernel form of the fitting
paths on a vertex subset with an empty part and V % 32 != 0; and the
applications (a converter, a flipper and a 10-step Adam refiner) on a small
synthetic full environment against the CPU port, with their launches; and
the tooling: ``check_kernel_parity`` on SMPL and SMPL-X, ``precompile.warm``
with the parity check, the sharded fit on an NCCL group of one rank equal
bit for bit to the fit, and the joint-regressor trainer on the card; and
the fit's stage spans under ``torch.profiler``: no device event of their
own, the stages' stream times adding up to the fit's; and the refiner's
step ``BodyFitterOpt.loss_and_grad`` at the benchmark's SMPL-X widths
against the CPU port and the float64 reference of ``portbench/``.
Operands are captured with ``chip_smoke.py``'s recorder and backward pass.

Marked ``cuda``; they skip where PyTorch sees no CUDA device. This file imports
no JAX, so on a machine without JAX run it, from the repository root, without
the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

import smplfitter_tpu_torch
from chip_smoke import (APP_LAUNCHES, BWD_CAPTURED, CAPTURED, GRAD_PATHS, SPECS, SPREAD_MULT,
                        app_parity, backward_pass, capture_forms, grad_path_counts,
                        params_v2v_mm, parity_spread, path_vg, record_calls, refine_loss,
                        weighted_fitters)
from port_on_cpu import port_model_from
from smplfitter_tpu_torch import BodyFitter, BodyModel, get_cached_fit_fn, get_fit_grad_fn
from smplfitter_tpu_torch.api import default_loss
from smplfitter_tpu_torch.ops import lbs_kernels
from smplfitter_tpu_torch.utils import profiling, synthetic

pytestmark = pytest.mark.cuda

REL_TOL = 1e-5  # max |kernel - twin| / its scale (_error_scales): f32 sums in another order
FIT_KW = dict(num_iter=3, beta_regularizer=1.0, final_adjust_rots=True,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
WRAPPERS = ('lbs_points', 'rhs_moments_h', 'gram_assembly', 'recon_part_sums_cached_lm')
NO_LAUNCHES = {name: 0 for name in lbs_kernels.LAUNCHES}


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
    def run():
        out = bm(*_params(batch, batch))
        fitter.fit(out['vertices'], out['joints'], **FIT_KW)

    return record_calls(lbs_kernels, WRAPPERS, run)


def _error_scales(name, args, want):
    """max|twin| per output, except K9's SA and r, which cancel by
    construction (a Jacobian centred by its own weighted mean; residuals of
    either sign): they are held to the Cauchy-Schwarz bounds of their terms,
    max sqrt(W G_ee) and max sqrt(G_ee sum ω |b|^2)."""
    scales = [t.abs().max().item() for t in want]
    if name == 'wgram_moments':
        G, _, r, _, W = want
        E1 = r.shape[0]
        diag = G.reshape(E1, E1, -1).diagonal(dim1=0, dim2=1)  # (B, E1)
        tgt, pj, homog, _, w, _, _, om = args[:8]
        V = om.shape[0]
        blend = torch.einsum('vj,xjb->xvb', w[:V], pj)
        pos = lbs_kernels._apply_blend(blend, homog[:, :V])
        bb = (((tgt - pos) ** 2).sum(dim=0) * om).sum(dim=0)
        scales[1] = (W[0][:, None] * diag).sqrt().max().item()
        scales[2] = (diag * bb[:, None]).sqrt().max().item()
    return scales


def _check_against_twin(name, calls):
    for args, kwargs in calls:
        got = getattr(lbs_kernels, name)(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = lbs_kernels.twin_call(name, args, kwargs)
        assert len(got) == len(want)
        for g, t, scale in zip(got, want, _error_scales(name, args, want)):
            torch.cuda.synchronize()
            assert g.shape == t.shape and g.is_cuda
            assert torch.isfinite(g).all()
            assert (g - t).abs().max().item() <= REL_TOL * scale


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
    pose, betas, trans = _params(batch, batch + 1)
    kid = np.random.default_rng(batch).normal(0, 0.5, batch).astype(np.float32)
    out = bm(pose, betas, trans, kid)
    tv, tj = out['vertices'], out['joints']

    def run():
        fitter.fit(tv, num_iter=2, requested_keys=('vertices',))
        kid_fitter.fit(tv, initial_pose_rotvecs=pose, initial_shape_betas=betas,
                       initial_kid_factor=kid, beta_regularizer=1e-2)
        fitter.fit_with_known_shape(betas, tv, tj, num_iter=2)
        fitter.fit(tv, tj, num_iter=2, scale_fit=True)

    return record_calls(lbs_kernels, PATH_WRAPPERS, run)


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
        NO_LAUNCHES, rhs_moments_h=3, gram_assembly=3, recon_part_sums_cached=3)


def test_fit_k2_pipeline_counts(card_models):
    """The headline fit's three K2 launches take the overlapped loop on long
    runs (B = 4096) and the serial one on short runs (B = 40)."""
    bm, fitter = card_models
    for batch, loop in ((4096, 'overlapped'), (40, 'serial')):
        out = bm(*_params(batch, 4))
        lbs_kernels.reset_launch_counts()
        fitter.fit(out['vertices'], out['joints'], **FIT_KW)
        assert lbs_kernels.LAUNCHES['rhs_moments_h'] == 3
        assert lbs_kernels.K2_PIPELINE == dict({'overlapped': 0, 'serial': 0}, **{loop: 3})


def test_fit_without_joints_launch_counts(card_models):
    bm, fitter = card_models
    out = bm(*_params(40, 3))
    lbs_kernels.reset_launch_counts()
    fitter.fit(out['vertices'], num_iter=3, final_adjust_rots=True,
               requested_keys=('pose_rotvecs', 'vertices'))
    assert lbs_kernels.LAUNCHES == dict(
        NO_LAUNCHES, lbs_points=4, rhs_moments=3, gram_assembly=3, part_sums=3)


def test_card_fit_matches_cpu_fit(card_models):
    bm, fitter = card_models
    out = bm(*_params(16, 2))
    tv, tj = out['vertices'], out['joints']
    card = fitter.fit(tv, tj, **FIT_KW)
    cpu = BodyFitter(port_model_from(bm)).fit(tv.cpu(), tj.cpu(), **FIT_KW)
    assert (card['shape_betas'].cpu() - cpu['shape_betas']).abs().max().item() <= 1e-3
    for key in ('pose_rotvecs', 'trans'):
        assert torch.allclose(card[key].cpu(), cpu[key], atol=1e-3), key


# ---------------------------------------------------------------------------
# SMPL-X: the large-model kernels (K7, K2 cached, K8, K4 at E = 17)
# ---------------------------------------------------------------------------

X_WRAPPERS = ('posed_template_lm', 'rhs_moments_cached', 'term1', 'recon_part_sums_cached_lm')


@pytest.fixture(scope='module')
def smplx_models(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    d = str(tmp_path_factory.mktemp('body_models_x'))
    synthetic.write_model_files(d, 'smplx', 1200, num_betas=16)
    bm = BodyModel('smplx', 'neutral', model_root=d + '/smplx', device='cuda')
    return bm, BodyFitter(bm), BodyFitter(bm, enable_kid=True)


def _smplx_params(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (batch, 165)).astype(np.float32),
            rng.normal(0, 1, (batch, 16)).astype(np.float32),
            rng.normal(0, 0.5, (batch, 3)).astype(np.float32))


def _capture_smplx(bm, fitter, kid_fitter, batch):
    """The large-model wrappers' arguments from the SMPL-X headline fit, a fit
    with the kid column and joints (E = 17) and a scale fit."""
    out = bm(*_smplx_params(batch, batch))
    tv, tj = out['vertices'], out['joints']

    def run():
        fitter.fit(tv, tj, **FIT_KW)
        kid_fitter.fit(tv, tj, num_iter=1)
        fitter.fit(tv, tj, num_iter=1, scale_fit=True)

    return record_calls(lbs_kernels, X_WRAPPERS, run)


@pytest.mark.parametrize('batch', [64, 37])
@pytest.mark.parametrize('name', X_WRAPPERS + ('rhs_moments_cached_scale',))
def test_large_model_kernel_matches_twin(smplx_models, name, batch):
    wrapper = name.removesuffix('_scale')
    calls = _capture_smplx(*smplx_models, batch)[wrapper]
    if wrapper == 'rhs_moments_cached':
        calls = [c for c in calls if c[1].get('scale', False) == name.endswith('_scale')]
    if wrapper == 'recon_part_sums_cached_lm':
        assert {c[0][2].shape[0] for c in calls} == {16, 17}
    assert calls, f'{name} was not called on the SMPL-X fits'
    _check_against_twin(wrapper, calls)


def test_smplx_fit_launch_counts(smplx_models):
    """Per solve K7, K2 cached and K8; K4 per rotation fit on the cache; no K3."""
    bm, fitter, _ = smplx_models
    out = bm(*_smplx_params(40, 5))
    lbs_kernels.reset_launch_counts()
    fitter.fit(out['vertices'], out['joints'], **FIT_KW)
    assert lbs_kernels.LAUNCHES == dict(NO_LAUNCHES, posed_template=3, rhs_moments_cached=3,
                                        term1=3, recon_part_sums_cached=3)
    assert lbs_kernels.K2_PIPELINE == {'overlapped': 0, 'serial': 3}


def _max_dbetas(a, b):
    return (a['shape_betas'].cpu() - b['shape_betas'].cpu()).abs().max().item()


def _own_spread(fit, tv, tj, base, seeds=3):
    """The largest change of the fit's betas over seeded changes of its
    targets by a factor 1 + 1e-7 N(0, 1) (the same changes on either device)."""
    spread = 0.0
    for seed in range(seeds):
        g = torch.Generator().manual_seed(seed)
        tv_n, tj_n = (t.cpu() * (1 + 1e-7 * torch.randn(t.shape, generator=g)) for t in (tv, tj))
        spread = max(spread, _max_dbetas(fit(tv_n.to(tv.device), tj_n.to(tv.device)), base))
    return spread


def _own_spreads(fit, tv, tj, base, v2v_mm, seeds=3):
    """As :func:`_own_spread`, and the largest change of the mean
    reconstruction error ``v2v_mm`` of the fit over the same changes."""
    spread, v2v_spread, base_mm = 0.0, 0.0, v2v_mm(base)
    for seed in range(seeds):
        g = torch.Generator().manual_seed(seed)
        tv_n, tj_n = (t.cpu() * (1 + 1e-7 * torch.randn(t.shape, generator=g)) for t in (tv, tj))
        res = fit(tv_n.to(tv.device), tj_n.to(tv.device))
        spread = max(spread, _max_dbetas(res, base))
        v2v_spread = max(v2v_spread, abs(v2v_mm(res) - base_mm))
    return spread, v2v_spread


def test_smplx_card_fit_matches_cpu_fit(smplx_models):
    """The one-solve known-pose fit under the bench gate's betas (1e-3); the
    headline fit, whose nearly degenerate finger parts amplify f32 rounding
    into the betas and the reconstruction, under the larger of the gate and
    4x the fit's own spread (the multiple of ``chip_smoke.SPREAD_MULT``,
    which says why): betas within the larger of 1e-3 and 4x their spread,
    and the mean reconstruction error within the larger of 0.01 mm and 4x
    its spread, under 1e-7 relative changes of the targets, on the CPU and
    on the card."""
    bm, fitter, _ = smplx_models
    pose, betas, trans = _smplx_params(16, 6)
    out = bm(pose, betas, trans)
    tv, tj = out['vertices'], out['joints']
    cpu_fitter = BodyFitter(port_model_from(bm))
    card = fitter.fit_with_known_pose(pose, tv)
    cpu = cpu_fitter.fit_with_known_pose(pose, tv.cpu())
    assert (card['shape_betas'].cpu() - cpu['shape_betas']).abs().max().item() <= 1e-3

    def v2v_mm(res):
        re = bm(glob_rotmats=res['orientations'].cuda(), shape_betas=res['shape_betas'].cuda(),
                trans=res['trans'].cuda())
        return (re['vertices'] - tv).norm(dim=-1).mean().item() * 1e3

    card = fitter.fit(tv, tj, **FIT_KW)
    cpu = cpu_fitter.fit(tv.cpu(), tj.cpu(), **FIT_KW)
    spreads = [_own_spreads(lambda a, b: cpu_fitter.fit(a, b, **FIT_KW), tv.cpu(), tj.cpu(), cpu,
                            v2v_mm),
               _own_spreads(lambda a, b: fitter.fit(a, b, **FIT_KW), tv, tj, card, v2v_mm)]
    spread = max(s[0] for s in spreads)
    v2v_spread = max(s[1] for s in spreads)
    gap = abs(v2v_mm(card) - v2v_mm(cpu))
    print(f'v2v gap {gap:.6f} mm, v2v spread cpu {spreads[0][1]:.6f} card {spreads[1][1]:.6f} '
          f'mm; betas gap {_max_dbetas(card, cpu):.3e}, spread {spread:.3e}')
    assert gap <= max(0.01, 4 * v2v_spread)
    assert _max_dbetas(card, cpu) <= max(1e-3, 4 * spread)


# ---------------------------------------------------------------------------
# Fit weights: K9 and the ω forms of K2, K4, K5 and K6
# ---------------------------------------------------------------------------

W_WRAPPERS = ('wgram_moments', 'rhs_moments_h', 'rhs_moments', 'part_sums_vm_lm',
              'recon_part_sums_lm', 'recon_part_sums_cached_lm')


def _fit_weights(batch, n, seed):
    return np.random.default_rng(seed).uniform(0.1, 2.0, (batch, n)).astype(np.float32)


@pytest.fixture(scope='module')
def static_fitter(card_models):
    bm = card_models[0]
    return BodyFitter(bm, vertex_weights=_fit_weights(1, bm.num_vertices, 7)[0],
                      joint_weights=_fit_weights(1, bm.num_joints, 8)[0])


def _capture_weighted(bm, fitter, static_fitter, batch):
    """The wrappers' arguments from per-call and static weighted fits: with
    and without joints, with a scale column, and the known-shape fit."""
    pose, betas, trans = _params(batch, batch + 2)
    out = bm(pose, betas, trans)
    tv, tj = out['vertices'], out['joints']
    vw = _fit_weights(batch, bm.num_vertices, batch)
    jw = _fit_weights(batch, bm.num_joints, batch + 1)

    def run():
        fitter.fit(tv, tj, vertex_weights=vw, joint_weights=jw, num_iter=2)
        fitter.fit(tv, vertex_weights=vw, num_iter=2, scale_fit=True)
        fitter.fit_with_known_shape(betas, tv, tj, vertex_weights=vw, joint_weights=jw)
        static_fitter.fit(tv, tj, num_iter=2)
        static_fitter.fit(tv, num_iter=2, scale_target=True)
        static_fitter.fit_with_known_shape(betas, tv, tj)

    calls = record_calls(lbs_kernels, W_WRAPPERS, run)
    return {name: [c for c in calls[name] if 'omega' in c[1] or name == 'wgram_moments']
            for name in W_WRAPPERS}


@pytest.mark.parametrize('batch', [64, 37])
@pytest.mark.parametrize('name', W_WRAPPERS + ('rhs_moments_cached',))
def test_weighted_kernel_matches_twin(card_models, static_fitter, name, batch):
    """Each ω form against its twin; K2's cached forms on the emit form's
    operands with their posed template."""
    calls = _capture_weighted(*card_models, static_fitter, batch)
    if name == 'rhs_moments_cached':
        calls = []
        for args, kwargs in _capture_weighted(*card_models, static_fitter, batch)[
                'rhs_moments_h']:
            tgt, pj, feat, w, consts, sd = args
            homog = lbs_kernels.posed_template_ref(feat, consts)
            calls += [((tgt, pj, homog, w, sd), dict(kwargs, scale=s)) for s in (False, True)]
    else:
        calls = calls[name]
    assert calls, f'{name} saw no weighted call'
    _check_against_twin(name, calls)


def test_weighted_fit_launch_counts(card_models, static_fitter):
    """Per call (weights of both kinds, joints): K5ω once on the T-pose, then
    per solve K7 and K9 and per later rotation fit K4ω. Static: K2 emit ω,
    K3 and K4ω per solve; the first rotation fit is one GEMM."""
    bm, fitter = card_models
    out = bm(*_params(40, 9))
    vw = _fit_weights(40, bm.num_vertices, 1)
    jw = _fit_weights(40, bm.num_joints, 2)
    lbs_kernels.reset_launch_counts()
    fitter.fit(out['vertices'], out['joints'], vertex_weights=vw, joint_weights=jw, **FIT_KW)
    assert lbs_kernels.LAUNCHES == dict(NO_LAUNCHES, part_sums_w=1, posed_template=3, wgram=3,
                                        recon_part_sums_cached_w=3)
    lbs_kernels.reset_launch_counts()
    static_fitter.fit(out['vertices'], out['joints'], **FIT_KW)
    assert lbs_kernels.LAUNCHES == dict(NO_LAUNCHES, rhs_moments_h_w=3, gram_assembly=3,
                                        recon_part_sums_cached_w=3)


@pytest.mark.parametrize('kind', ['per_call', 'static'])
def test_weighted_card_fit_matches_cpu_fit(card_models, static_fitter, kind):
    bm, fitter = card_models
    out = bm(*_params(16, 4))
    tv, tj = out['vertices'], out['joints']
    cpu_bm = port_model_from(bm)
    if kind == 'per_call':
        kw = dict(FIT_KW, vertex_weights=_fit_weights(16, bm.num_vertices, 3),
                  joint_weights=_fit_weights(16, bm.num_joints, 4))
        card, cpu_fitter = fitter.fit(tv, tj, **kw), BodyFitter(cpu_bm)
    else:
        kw = FIT_KW
        card = static_fitter.fit(tv, tj, **kw)
        cpu_fitter = BodyFitter(cpu_bm, vertex_weights=static_fitter.static_vw,
                                joint_weights=static_fitter.static_jw)
    cpu = cpu_fitter.fit(tv.cpu(), tj.cpu(), **kw)
    assert (card['shape_betas'].cpu() - cpu['shape_betas']).abs().max().item() <= 1e-3
    for key in ('pose_rotvecs', 'trans'):
        assert torch.allclose(card[key].cpu(), cpu[key], atol=1e-3), key


# ---------------------------------------------------------------------------
# Gradients: the backward kernels K10-K13 and the gradient of the fit
# ---------------------------------------------------------------------------

BWD_WRAPPERS = ('lbs_points_bwd', 'rhs_moments_bwd', 'rhs_moments_cached_bwd',
                'recon_part_sums_cached_bwd')


def _capture_backward(bm, fitters, params):
    """The backward wrappers' arguments from the gradient of a forward pass
    and of each fitter's headline and known-pose fits."""
    params = [torch.as_tensor(x, device='cuda') for x in params]
    return record_calls(lbs_kernels, BWD_WRAPPERS,
                        lambda: backward_pass(torch, bm, fitters, params))


@pytest.mark.parametrize('batch', [64, 1000])
@pytest.mark.parametrize('name', BWD_WRAPPERS)
def test_backward_kernel_matches_twin(card_models, static_fitter, smplx_models, name, batch):
    """K10-K13 against their twins on the operands of real backward passes:
    SMPL's forward pass, headline and known-pose fits, unweighted and with
    static weights (the ω forms of K11 and K13; the known-pose fit runs K11's
    plain form), and SMPL-X's (K10 at F = 503, K12, K13 at J = 55)."""
    calls = _capture_backward(card_models[0], (card_models[1], static_fitter),
                              _params(batch, batch + 5))[name]
    if name != 'rhs_moments_bwd':
        calls += _capture_backward(smplx_models[0], smplx_models[1:2],
                                   _smplx_params(batch, batch + 6))[name]
    assert calls, f'{name} was not called by the backward passes'
    if name in ('rhs_moments_bwd', 'recon_part_sums_cached_bwd'):
        assert any(kw.get('omega') is not None for _, kw in calls)
    if name == 'rhs_moments_bwd':
        assert {kw['gh'] is None for _, kw in calls} == {True, False}
    _check_against_twin(name, calls)


def test_gradient_launch_counts(card_models):
    """One backward kernel per forward kernel of the SMPL headline fit."""
    bm, fitter = card_models
    out = bm(*_params(40, 10))
    tv = out['vertices'].detach().requires_grad_()
    tj = out['joints'].detach().requires_grad_()
    loss = default_loss(fitter.fit(tv, tj, **FIT_KW))
    lbs_kernels.reset_launch_counts()
    torch.autograd.grad(loss, (tv, tj))
    assert lbs_kernels.LAUNCHES == dict(NO_LAUNCHES, rhs_moments_h_bwd=3,
                                        recon_part_sums_cached_bwd=3)


def test_headline_fit_gradient_matches_cpu(card_models):
    """The gradient of a loss of the headline fit with respect to its targets,
    on the card and on the CPU, B = 32, within 1e-3 of max|g_cpu| (the JAX
    package's limit for its kernel gradient, tests/test_tpu_grad.py). Before
    the backward kernels the card's gradient left out the kernels' share."""
    bm, fitter = card_models
    out = bm(*_params(32, 11))
    grads = []
    for fit, dev in ((fitter, 'cuda'), (BodyFitter(port_model_from(bm)), 'cpu')):
        tv = out['vertices'].detach().to(dev).requires_grad_()
        tj = out['joints'].detach().to(dev).requires_grad_()
        grads.append(torch.autograd.grad(default_loss(fit.fit(tv, tj, **FIT_KW)), (tv, tj)))
    for g, c in zip(*grads):
        assert torch.isfinite(g).all()
        assert (g.cpu() - c).abs().max().item() <= 1e-3 * c.abs().max().item()


def test_smplx_fit_gradient_matches_cpu(smplx_models):
    """SMPL-X with one iteration, whose gradient runs the large-model route's
    backward (K7's GEMM, the streamed Gramian term's, K12, K13), on the card
    and on the CPU within 1e-3 of max|g_cpu|. Three iterations amplify f32
    rounding on the hands beyond that (chip_smoke.py phase 15)."""
    bm, fitter, _ = smplx_models
    out = bm(*_smplx_params(32, 15))
    tv, tj = out['vertices'], out['joints']
    card = get_fit_grad_fn(fitter, num_iter=1)(tv, tj)[1]
    cpu = get_fit_grad_fn(BodyFitter(port_model_from(bm)), num_iter=1)(tv.cpu(), tj.cpu())[1]
    for g, c in zip(card, cpu):
        assert torch.isfinite(g).all()
        assert (g.cpu() - c).abs().max().item() <= 1e-3 * c.abs().max().item()


def test_forward_gradient_matches_cpu(card_models):
    bm = card_models[0]
    cpu_bm = port_model_from(bm)
    grads = []
    for model, dev in ((bm, 'cuda'), (cpu_bm, 'cpu')):
        p = [torch.as_tensor(x, device=dev).requires_grad_() for x in _params(32, 12)]
        grads.append(torch.autograd.grad(torch.sin(model(*p)['vertices']).sum(), p))
    for g, c in zip(*grads):
        assert (g.cpu() - c).abs().max().item() <= 1e-5 * c.abs().max().item()


# ---------------------------------------------------------------------------
# Gradients of the other fitting paths: K14, K15 and the torch-op backward passes
# ---------------------------------------------------------------------------


def _path_fitters(card_models, kid_fitter, static_fitter):
    """GRAD_PATHS' fitters; the static fitter also serves as 'static_vw'."""
    return dict(plain=card_models[1], kid=kid_fitter, static=static_fitter,
                static_vw=static_fitter)


@pytest.mark.parametrize('batch', [64, 1000])
@pytest.mark.parametrize('name', ['part_sums_bwd', 'recon_part_sums_bwd'])
def test_path_backward_kernel_matches_twin(card_models, kid_fitter, static_fitter, name, batch):
    """K14 and K15 (unweighted and ω) against their twins on the operands of
    the gradients of chip_smoke.CAPTURE_PATHS on SMPL."""
    bm = card_models[0]
    params = [torch.as_tensor(x, device='cuda') for x in _params(batch, batch + 9)]
    calls = record_calls(lbs_kernels, (name,), lambda: backward_pass(
        torch, bm, (), params, _path_fitters(card_models, kid_fitter, static_fitter)))[name]
    assert {kw.get('omega') is None for _, kw in calls} == {True, False}
    _check_against_twin(name, calls)


@pytest.mark.parametrize('path', list(GRAD_PATHS))
def test_path_gradient_launch_counts(card_models, kid_fitter, static_fitter, path):
    """Each gradient path's value and gradient launches the kernels and runs
    the torch-op backward passes that chip_smoke.GRAD_PATHS lists."""
    bm = card_models[0]
    p = tuple(torch.as_tensor(x, device='cuda') for x in _params(40, 17))
    p += (torch.linspace(-0.5, 0.5, 40, device='cuda'),
          torch.as_tensor(_fit_weights(40, bm.num_vertices, 18), device='cuda'),
          torch.as_tensor(_fit_weights(40, bm.num_joints, 19), device='cuda'))
    out = bm(*p[:3])
    lbs_kernels.reset_launch_counts()
    _, grads = path_vg(torch, path, _path_fitters(card_models, kid_fitter, static_fitter), p)(
        out['vertices'], out['joints'])
    launches, vjps = grad_path_counts(path, 'smpl')
    assert lbs_kernels.LAUNCHES == dict(NO_LAUNCHES, **launches)
    assert {k: n for k, n in lbs_kernels.TORCH_VJPS.items() if n} == vjps
    assert all(torch.isfinite(g).all() for g in grads)


def test_call_weighted_fit_gradient_matches_cpu(card_models):
    """The per-call weighted headline fit (K5 with a batch-constant
    reference, K9 and K4 under per-call ω, all with torch-op backward passes)
    differentiated in the targets and the weights, on the card and on the
    CPU, B = 32, within 1e-3 of max|g_cpu|."""
    bm, fitter = card_models
    out = bm(*_params(32, 13))
    vw = torch.as_tensor(_fit_weights(32, bm.num_vertices, 5), device='cuda')
    jw = torch.as_tensor(_fit_weights(32, bm.num_joints, 6), device='cuda')
    grads = []
    for fit, dev in ((fitter, 'cuda'), (BodyFitter(port_model_from(bm)), 'cpu')):
        leaves = [t.detach().to(dev).requires_grad_() for t in (out['vertices'], out['joints'],
                                                                 vw)]
        res = fit.fit(leaves[0], leaves[1], vertex_weights=leaves[2], joint_weights=jw.to(dev),
                      **FIT_KW)
        grads.append(torch.autograd.grad(default_loss(res), leaves))
    for g, c in zip(*grads):
        assert torch.isfinite(g).all()
        assert (g.cpu() - c).abs().max().item() <= 1e-3 * c.abs().max().item()


# ---------------------------------------------------------------------------
# K7 and K8, the register-tiled GEMMs, at the shapes whose edges they mask
# ---------------------------------------------------------------------------

# (F, V_pad): MANO, SMPL, SMPL+H and SMPL-X widths; 3 V_pad = 3000 rows is
# not a multiple of the 128-row tile.
K7_SHAPES = [(136, 1024), (208, 6912), (460, 6912), (487, 10496), (487, 1000)]
# (J3, E): SMPL+H and SMPL-X, E = 17 (the kid column: E^2 = 289, rows not
# 16-byte aligned); E = 32 (the limit: one split at B = 4096).
K8_SHAPES = [(156, 16), (165, 16), (165, 17), (72, 32)]
GEMM_BATCHES = [1, 37, 1000, 4096]


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _normal(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((scale * rng.normal(size=shape)).astype(np.float32), device='cuda')


def _rotation_rows(seed, J3, batch):
    """R (3, J3, B): the rows (joint, c) of seeded rotation matrices."""
    q = np.linalg.qr(np.random.default_rng(seed).normal(size=(batch, J3 // 3, 3, 3)))[0]
    R = q.transpose(2, 1, 3, 0).reshape(3, J3, batch)  # R[a, 3 j + c, b] = q[b, j, a, c]
    return torch.as_tensor(np.ascontiguousarray(R, dtype=np.float32), device='cuda')


def _hold_and_repeat(wrapper, args):
    """Within REL_TOL x max|twin| of the twin, and bit for bit on a second call."""
    with torch.no_grad():
        got = getattr(lbs_kernels, wrapper)(*args)
        again = getattr(lbs_kernels, wrapper)(*args)
        (want,) = lbs_kernels.twin_call(wrapper, args, {})
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= REL_TOL * want.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize('batch', GEMM_BATCHES)
@pytest.mark.parametrize('F, Vp', K7_SHAPES)
def test_posed_template_kernel_at_edges(card, F, Vp, batch):
    consts = _normal(F + Vp, 4, Vp, F, scale=0.1)
    feat = _normal(batch, F, batch)
    lbs_kernels.reset_launch_counts()
    _hold_and_repeat('posed_template_lm', (feat, consts))
    assert lbs_kernels.LAUNCHES['posed_template'] == 2


@pytest.mark.parametrize('batch', GEMM_BATCHES)
@pytest.mark.parametrize('J3, E', K8_SHAPES)
def test_term1_kernel_at_edges(card, J3, E, batch):
    ksd = _normal(J3 + E, J3 * J3, E * E)
    R = _rotation_rows(batch, J3, batch)
    lbs_kernels.reset_launch_counts()
    _hold_and_repeat('term1', (R, ksd))
    assert lbs_kernels.LAUNCHES['term1'] == 2


# (J, E): SMPL (E = 10, the kid column 11, 16) and MANO (J = 16). At J = 24,
# E = 16 the wrapper streams term1 (K8); K3 is held there all the same.
K3_SHAPES = [(J, E) for J in (24, 16) for E in (10, 11, 16)]
K3_BATCHES = [1, 17, 32, 1000, 4096]


@pytest.mark.parametrize('has_joints', [False, True])
@pytest.mark.parametrize('J, E', K3_SHAPES)
def test_gram_assembly_kernel_at_edges(card, J, E, has_joints):
    """K3 (term1's split-K GEMM with 128-row tiles, then the per-column terms
    and the ordered split sum) on seeded operands at every batch of
    K3_BATCHES: each output within REL_TOL x max|twin| of the twin, and bit
    for bit on a second call; two device kernels, one count per call."""
    J3, EJ = 3 * J, E * J
    seed = 100 * J + E
    static = (_normal(seed, J3 * J3, E * E, scale=0.1), _normal(seed + 1, J3, EJ, scale=0.3),
              _normal(seed + 2, J3, E), _normal(seed + 3, J, J, scale=0.2),
              _normal(seed + 4, J, 1))
    for batch in K3_BATCHES:
        s = seed + batch
        rows = EJ if has_joints else 1
        args = (_rotation_rows(s, J3, batch), _normal(s + 5, 3, EJ, batch),
                _normal(s + 6, 3, J, batch), _normal(s + 7, 3, rows, batch),
                _normal(s + 8, 3, J if has_joints else 1, batch)) + static
        lbs_kernels.reset_launch_counts()
        with torch.no_grad():
            got = lbs_kernels._GramAssembly.apply(*args, has_joints)
            again = lbs_kernels._GramAssembly.apply(*args, has_joints)
            want = lbs_kernels.gram_assembly_ref(*args, has_joints=has_joints)
        torch.cuda.synchronize()
        assert lbs_kernels.LAUNCHES['gram_assembly'] == 2
        for g, a, t in zip(got, again, want, strict=True):
            assert g.shape == t.shape and g.is_cuda and torch.isfinite(g).all()
            assert (g - t).abs().max().item() <= REL_TOL * t.abs().max().item()
            assert torch.equal(g, a)


# ---------------------------------------------------------------------------
# K9 and K6 at their edges: blends over each segment's active joints
# ---------------------------------------------------------------------------

WGRAM_SHAPES = [(J, E) for J in (16, 24, 55) for E in (10, 17, 32)]
EDGE_BATCHES = [1, 7, 33, 300]


def _skinning(seed, V, J, dense):
    """(V_pad, J) weights, zero rows past V: every joint on every vertex
    (dense) or three of them (a vertex's joint and the two below it), as the
    synthetic models give."""
    rng = np.random.default_rng(seed)
    vp = -(-V // lbs_kernels.VC) * lbs_kernels.VC
    w = np.zeros((vp, J))
    if dense:
        w[:V] = rng.uniform(0.01, 1.0, (V, J))
    else:
        own = rng.integers(0, J, V)
        for k, share in enumerate((0.75, 0.2, 0.05)):
            np.add.at(w, (np.arange(V), np.maximum(own - k, 0)), share)
    w[:V] /= w[:V].sum(axis=1, keepdims=True)
    return torch.as_tensor(w.astype(np.float32), device='cuda')


def _hold_all(wrapper, args, kwargs, launches_key):
    """Every output within REL_TOL of its error scale of the twin's, and bit
    for bit on a second call; one launch per call. Returns the outputs."""
    lbs_kernels.reset_launch_counts()
    with torch.no_grad():
        got = getattr(lbs_kernels, wrapper)(*args, **kwargs)
        again = getattr(lbs_kernels, wrapper)(*args, **kwargs)
        want = lbs_kernels.twin_call(wrapper, args, kwargs)
    torch.cuda.synchronize()
    assert lbs_kernels.LAUNCHES[launches_key] == 2
    got, again = (x if isinstance(x, tuple) else (x,) for x in (got, again))
    for g, a, t, scale in zip(got, again, want, _error_scales(wrapper, args, want), strict=True):
        assert g.shape == t.shape and g.is_cuda and torch.isfinite(g).all()
        assert (g - t).abs().max().item() <= REL_TOL * scale
        assert torch.equal(g, a)
    return got


@pytest.mark.parametrize('dense', [False, True])
@pytest.mark.parametrize('scale_mode', [0, 1, 2])
@pytest.mark.parametrize('J, E', WGRAM_SHAPES)
def test_wgram_kernel_at_edges(card, J, E, scale_mode, dense):
    """K9 on seeded operands: V = 300 (partial segments), ω with zero rows,
    every batch of EDGE_BATCHES, E up to 32 with and without the scale
    column."""
    V = 300
    w = _skinning(J + E, V, J, dense)
    vp = w.shape[0]
    cover = lbs_kernels.wgram_cover(w.cpu().numpy(), V, 'cuda')
    for batch in EDGE_BATCHES:
        seed = 1000 * J + 10 * E + batch
        om = torch.as_tensor(np.random.default_rng(seed).uniform(0.1, 2.0, (V, batch)),
                             dtype=torch.float32, device='cuda')
        om[::7] = 0.0
        args = (_normal(seed, 3, V, batch), _normal(seed + 1, 12, J, batch, scale=0.5),
                _normal(seed + 2, 3, vp, batch, scale=0.3),
                _normal(seed + 3, 3 * E, J, batch, scale=0.1), w,
                _normal(seed + 4, 3, vp, E, scale=0.05), _normal(seed + 5, 3 * E, batch, scale=0.1),
                om)
        kw = dict(scale_mode=scale_mode, cover=cover,
                  mu_s=_normal(seed + 6, 3, batch) if scale_mode else None)
        _hold_all('wgram_moments', args, kw, 'wgram')


def _parts(V, J):
    """A membership with parts of 1, 63 and 513 vertices (two segments), the
    rest round-robin, every 11th vertex in no part."""
    vp = -(-V // lbs_kernels.VC) * lbs_kernels.VC
    pm = np.zeros((J, vp), np.float32)
    sizes = [1, 63, 513]
    start = 0
    for j, n in enumerate(sizes):
        pm[j, start:start + n] = 1
        start += n
    for v in range(start, V):
        if v % 11:
            pm[len(sizes) + v % (J - len(sizes)), v] = 1
    return pm


@pytest.mark.parametrize('dense', [False, True])
@pytest.mark.parametrize('omega', [None, 'static', 'call'])
@pytest.mark.parametrize('F', [219, 503])
def test_recon_part_sums_kernel_at_edges(card, F, omega, dense):
    """K6 on seeded operands at both template widths, unweighted and both ω
    forms, at every batch of EDGE_BATCHES."""
    V, J = 900, 24
    w = _skinning(F + J, V, J, dense)
    vp = w.shape[0]
    parts = lbs_kernels.PartIndex.from_membership(_parts(V, J), 'cuda', weights=w.cpu().numpy())
    consts = _normal(F, 4, vp, F, scale=0.05)
    for batch in EDGE_BATCHES:
        seed = 10 * F + batch
        args = (_normal(seed, 3, V, batch), _normal(seed + 1, 12, J, batch, scale=0.5),
                _normal(seed + 2, F, batch), w, consts, parts)
        kw = {}
        if omega is not None:
            rows, cols = (vp, 1) if omega == 'static' else (V, batch)
            om = np.random.default_rng(seed).uniform(0.1, 2.0, (rows, cols))
            om[::5] = 0.0
            kw['omega'] = torch.as_tensor(om, dtype=torch.float32, device='cuda')
        _hold_all('recon_part_sums_lm', args, kw,
                  'recon_part_sums' + ('' if omega is None else '_w'))


# ---------------------------------------------------------------------------
# K1 and K2 at their edges: covers of 32-vertex segments with active joints
# ---------------------------------------------------------------------------

COVER_V = 1001  # V % 32 != 0: partial segments; V_pad = 1024
COVER_BATCHES = [1, 33, 130, 256]  # B % 4 != 0 (4-byte paths), a partial and a full 128-column tile
K2_FORMS = {'emit': ('rhs_moments_h', {}, 'rhs_moments_h'),
            'plain': ('rhs_moments', {}, 'rhs_moments'),
            'scale': ('rhs_moments', dict(scale=True), 'rhs_moments_scale'),
            'cached': ('rhs_moments_cached', {}, 'rhs_moments_cached'),
            'cached_scale': ('rhs_moments_cached', dict(scale=True), 'rhs_moments_cached_scale')}


def _template(seed, F, vp, V):
    """consts (4, V_pad, F), zero rows past V as a model's."""
    consts = _normal(seed, 4, vp, F, scale=0.05)
    consts[:, V:] = 0.0
    return consts


@pytest.mark.parametrize('dense', [False, True])
@pytest.mark.parametrize('F', [219, 503])
def test_lbs_points_kernel_at_edges(card, F, dense):
    """K1 on seeded operands at both template widths, sparse and dense
    weights, every batch of COVER_BATCHES: within REL_TOL of the twin, bit
    for bit on a repeat, rows past the cover exactly zero; and with no cover
    (built on the host, counted)."""
    J = 24
    w = _skinning(F + J + 1, COVER_V, J, dense)
    vp = w.shape[0]
    cover = lbs_kernels.wgram_cover(w.cpu().numpy(), COVER_V, 'cuda')
    consts = _template(F, F, vp, COVER_V)
    for batch in COVER_BATCHES:
        seed = 10 * F + batch
        args = (_normal(seed, 12, J, batch, scale=0.5), _normal(seed + 1, F, batch), w, consts)
        (got,) = _hold_all('lbs_points', args, dict(cover=cover), 'lbs_points')
        assert torch.equal(got[:, COVER_V:], torch.zeros_like(got[:, COVER_V:]))
    with torch.no_grad():
        built = lbs_kernels.lbs_points(*args)
    assert lbs_kernels.HOST_COVERS['lbs_points'] == 1
    assert torch.equal(built, got)


@pytest.mark.parametrize('dense', [False, True])
@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('E', [10, 32])
@pytest.mark.parametrize('form', list(K2_FORMS))
def test_rhs_moments_kernel_at_edges(card, form, E, omega, dense):
    """Every K2 form on seeded operands: E = 10 and 32, unweighted and
    static ω (zero rows), sparse and dense weights, targets of all V rows
    and of fewer (Vt < V), every batch of COVER_BATCHES; within REL_TOL of
    the twin, bit for bit on a repeat, the emitted template's rows past the
    cover exactly zero."""
    wrapper, extra, key = K2_FORMS[form]
    J, F = 24, 208
    w = _skinning(J + E + 2, COVER_V, J, dense)
    vp = w.shape[0]
    cover = lbs_kernels.wgram_cover(w.cpu().numpy(), COVER_V, 'cuda')
    consts = _template(F + E, F, vp, COVER_V)
    sd = _normal(E, 3, vp, E, scale=0.05)
    kw = dict(extra, cover=cover)
    if omega:
        om = np.random.default_rng(E).uniform(0.1, 2.0, (vp, 1))
        om[::5] = 0.0
        om[COVER_V:] = 0.0
        kw['omega'] = torch.as_tensor(om, dtype=torch.float32, device='cuda')
    for batch, v_t in zip(COVER_BATCHES, (COVER_V, COVER_V - 37, COVER_V, COVER_V - 300)):
        seed = 1000 * E + batch
        tgt, pj = _normal(seed, 3, v_t, batch), _normal(seed + 1, 12, J, batch, scale=0.5)
        feat = _normal(seed + 2, F, batch)
        if wrapper == 'rhs_moments_cached':
            args = (tgt, pj, lbs_kernels.posed_template_ref(feat, consts), w, sd)
        else:
            args = (tgt, pj, feat, w, consts, sd)
        out = _hold_all(wrapper, args, kw, key + ('_w' if omega else ''))
        if form == 'emit':
            assert torch.equal(out[2][:, COVER_V:], torch.zeros_like(out[2][:, COVER_V:]))


# K2's overlapped loop: (V, batch, target rows). At V = 1001 the runs hold
# 12 segments and the last 11 (9 with dense weights), or at B = 2304 7 and
# the last 5 (3): odd counts of tiles; B = 4099 takes the 4-byte path and its
# last block's 3 columns leave the second group of warps idle, B = 4196's
# last block gives that group 36 live columns. At V = 6890 and B = 32 the
# runs hold 2 segments: the serial loop.
K2_OVERLAP_CASES = [(1001, 4096, 1001), (1001, 4099, 964), (1001, 4196, 1001),
                    (1001, 2304, 701), (6890, 32, 6890), (6890, 32, 6853)]


@pytest.mark.parametrize('dense', [False, True])
@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('E', [11, 32])
@pytest.mark.parametrize('form', ['emit', 'plain', 'scale'])
def test_rhs_moments_overlapped_loop(card, form, E, omega, dense):
    """K2's template-dot forms on runs long enough for the overlapped loop
    (and at B = 32 on the serial one), E = 11 and 32, unweighted and static
    ω, sparse and dense weights, targets of all V rows and of fewer: within
    REL_TOL of the twin, bit for bit on a repeat, each launch counted under
    the loop it took."""
    wrapper, extra, key = K2_FORMS[form]
    J, F = 24, 208
    for V, batch, v_t in K2_OVERLAP_CASES:
        w = _skinning(J + E + V, V, J, dense)
        vp = w.shape[0]
        cover = lbs_kernels.wgram_cover(w.cpu().numpy(), V, 'cuda')
        per_block, _ = lbs_kernels._segment_runs(cover.n_seg, batch, 'cuda', 1)
        loop = 'overlapped' if per_block >= lbs_kernels.K2_OVERLAP_MIN_TILES else 'serial'
        assert loop == ('serial' if batch == 32 else 'overlapped')
        consts = _template(F + V, F, vp, V)
        sd = _normal(E + V, 3, vp, E, scale=0.05)
        kw = dict(extra, cover=cover)
        if omega:
            om = np.random.default_rng(E + V).uniform(0.1, 2.0, (vp, 1))
            om[::5] = 0.0
            om[V:] = 0.0
            kw['omega'] = torch.as_tensor(om, dtype=torch.float32, device='cuda')
        seed = 1000 * E + batch + v_t
        args = (_normal(seed, 3, v_t, batch), _normal(seed + 1, 12, J, batch, scale=0.5),
                _normal(seed + 2, F, batch), w, consts, sd)
        out = _hold_all(wrapper, args, kw, key + ('_w' if omega else ''))
        assert lbs_kernels.K2_PIPELINE == dict({'overlapped': 0, 'serial': 0}, **{loop: 2})
        if form == 'emit':
            assert torch.equal(out[2][:, V:], torch.zeros_like(out[2][:, V:]))


# ---------------------------------------------------------------------------
# K10 and K14 at their edges: fronts over a cover's or a part index's tiles
# ---------------------------------------------------------------------------

# (V, J, F): MANO V = 778 (V % 256 = 10: a short last segment), SMPL and
# SMPL-X widths with their fitted meshes' template widths.
BWD_SHAPES = {'mano': (778, 16, 146), 'smpl': (6890, 24, 219), 'smplx': (10475, 55, 503)}
BWD_BATCHES = [1, 33, 256]


def _bwd_model(name, dense):
    V, J, F = BWD_SHAPES[name]
    w = _skinning(V + J, V, J, dense)
    return V, J, F, w, _template(F + 3, F, w.shape[0], V)


@pytest.mark.parametrize('name, dense', [('mano', False), ('smpl', False), ('smplx', False),
                                         ('smplx', True)])
def test_lbs_points_bwd_kernel_at_edges(card, name, dense):
    """K10 on seeded operands over the model's cover: within REL_TOL of the
    twin and bit for bit on a repeat at every batch of BWD_BATCHES; without
    a cover (one of every V_pad row built on the host, counted; its segments
    group the rows otherwise, so its sums run in another order) within
    REL_TOL of the twin."""
    V, J, F, w, consts = _bwd_model(name, dense)
    vp = w.shape[0]
    cover = lbs_kernels.wgram_cover(w.cpu().numpy(), V, 'cuda')
    for batch in BWD_BATCHES:
        seed = 10 * V + batch
        args = (_normal(seed, 3, vp, batch), _normal(seed + 1, 12, J, batch, scale=0.5),
                _normal(seed + 2, F, batch), w, consts)
        _hold_all('lbs_points_bwd', args, dict(cover=cover), 'lbs_points_bwd')
    with torch.no_grad():
        built = lbs_kernels.lbs_points_bwd(*args)
        want = lbs_kernels.twin_call('lbs_points_bwd', args, {})
    assert lbs_kernels.HOST_COVERS['lbs_points_bwd'] == 1
    for b, t in zip(built, want, strict=True):
        assert (b - t).abs().max().item() <= REL_TOL * t.abs().max().item()


@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('name, dense', [('mano', False), ('smpl', False), ('smplx', False),
                                         ('smplx', True)])
def test_recon_part_sums_bwd_kernel_at_edges(card, name, dense, omega):
    """K14 (unweighted and static ω) on seeded operands over a part index of
    parts of 1, 63 and 513 vertices and every 11th vertex in none (their
    dtgt rows zero), targets of all V rows and of fewer: within REL_TOL of
    the twin and bit for bit on a repeat at every batch of BWD_BATCHES."""
    V, J, F, w, consts = _bwd_model(name, dense)
    vp = w.shape[0]
    parts = lbs_kernels.PartIndex.from_membership(_parts(V, J), 'cuda', weights=w.cpu().numpy())
    kw = {}
    if omega:
        om = np.random.default_rng(V).uniform(0.1, 2.0, (vp, 1))
        om[::5] = 0.0
        om[V:] = 0.0
        kw['omega'] = torch.as_tensor(om, dtype=torch.float32, device='cuda')
    for batch, v_t in zip(BWD_BATCHES, (V, V - 37, V)):
        seed = 10 * V + batch
        args = (_normal(seed, 9, J, batch), _normal(seed + 1, 3, J, batch),
                _normal(seed + 2, 3, J, batch), _normal(seed + 3, 3, v_t, batch),
                _normal(seed + 4, 12, J, batch, scale=0.5), _normal(seed + 5, F, batch), w,
                consts, parts)
        (dtgt, _, _) = _hold_all('recon_part_sums_bwd', args, kw,
                                 'recon_part_sums_bwd' + ('_w' if omega else ''))
        none = parts.unused[parts.unused < v_t].long()
        assert torch.equal(dtgt[:, none], torch.zeros_like(dtgt[:, none]))


# (V, J): MANO V = 778 (V % 256 = 10) and SMPL widths.
PSB_SHAPES = {'mano': (778, 16), 'smpl': (6890, 24)}
PSB_BATCHES = [1, 33, 256, 1001]  # B % 4 != 0 (4-byte paths), one and several 128-column blocks


@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('summed', [False, True])
@pytest.mark.parametrize('name', list(PSB_SHAPES))
def test_part_sums_bwd_kernel_at_edges(card, name, summed, omega):
    """K15 (batched or summed, unweighted or static ω) on seeded operands
    over a part index of parts of 1, 63 and 513 vertices and every 11th
    vertex in none (their rows zero), with V_t = V_a, V_t < V_a and
    V_t > V_a: within REL_TOL of the twin and bit for bit on a repeat at
    every batch of PSB_BATCHES."""
    V, J = PSB_SHAPES[name]
    vp = -(-V // lbs_kernels.VC) * lbs_kernels.VC
    parts = lbs_kernels.PartIndex.from_membership(_parts(V, J), 'cuda')
    kw = {}
    if omega:
        om = np.random.default_rng(V).uniform(0.1, 2.0, (vp, 1))
        om[::5] = 0.0
        om[V:] = 0.0
        kw['omega'] = torch.as_tensor(om, dtype=torch.float32, device='cuda')
    rows = [(V, V), (V - 37, V), (V, V - 37), (V - 37, V)]
    for batch, (v_t, v_a) in zip(PSB_BATCHES, rows):
        # One column: the batched form (the wrapper sums nothing).
        key = 'part_sums_bwd' + ('_sum' if summed and batch > 1 else '') + ('_w' if omega else '')
        seed = 10 * V + batch
        cols = 1 if summed else batch
        args = (_normal(seed, 9, J, batch), _normal(seed + 1, 3, J, batch),
                _normal(seed + 2, 3, J, cols), _normal(seed + 3, 3, v_t, batch),
                _normal(seed + 4, 3, v_a, cols), parts)
        dt, da = _hold_all('part_sums_bwd', args, kw, key)
        for out, n in ((dt, v_t), (da, v_a)):
            none = parts.unused[parts.unused < n].long()
            assert torch.equal(out[:, none], torch.zeros_like(out[:, none]))


# ---------------------------------------------------------------------------
# K11 and K12 at their edges: fronts over K2's cover
# ---------------------------------------------------------------------------

RHS_BWD_BATCHES = [1, 33, 1000, 4097]  # B % 4 != 0 (4-byte paths), one and many 128-column tiles
RHS_BWD_FORMS = {'emit': 'rhs_moments_h_bwd', 'plain': 'rhs_moments_bwd',
                 'cached': 'rhs_moments_cached_bwd'}


@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('name, dense', [('mano', False), ('smpl', False), ('smplx', False),
                                         ('smplx', True)])
@pytest.mark.parametrize('form', list(RHS_BWD_FORMS))
def test_rhs_moments_bwd_kernel_at_edges(card, form, name, dense, omega):
    """K11 (emit with gh random on every row, plain) and K12, unweighted
    and static ω (zero rows), on seeded operands over
    the model's cover at MANO, SMPL and SMPL-X widths and dense SMPL-X
    weights, E = 17 and 32, targets of all V rows and of fewer (V_t < V <
    V_pad), at every batch of RHS_BWD_BATCHES: within REL_TOL of the twin
    and bit for bit on a repeat; K12's dh exactly zero past the cover."""
    V, J, F, w, consts = _bwd_model(name, dense)
    vp = w.shape[0]
    cover = lbs_kernels.wgram_cover(w.cpu().numpy(), V, 'cuda')
    kw = dict(cover=cover)
    if omega:
        kw['omega'] = _static_omega(V, vp, V + J)
    for batch, v_t, E in zip(RHS_BWD_BATCHES, (V, V - 37, V, V - 300), (17, 32, 32, 17)):
        seed = 10 * V + batch
        gr, gy = _normal(seed, E, batch), _normal(seed + 1, 3, J, batch)
        tgt, pj = _normal(seed + 2, 3, v_t, batch), _normal(seed + 3, 12, J, batch, scale=0.5)
        sd, feat = _normal(seed + 4, 3, vp, E, scale=0.05), _normal(seed + 5, F, batch)
        if form == 'cached':
            homog = lbs_kernels.posed_template_ref(feat, consts)
            wrapper, args, extra = 'rhs_moments_cached_bwd', (gr, gy, tgt, pj, homog, w, sd), {}
        else:
            wrapper, args = 'rhs_moments_bwd', (gr, gy, tgt, pj, feat, w, consts, sd)
            extra = dict(gh=_normal(seed + 6, 3, vp, batch)) if form == 'emit' else {}
        out = _hold_all(wrapper, args, dict(kw, **extra),
                        RHS_BWD_FORMS[form] + ('_w' if omega else ''))
        if form == 'cached':
            assert torch.equal(out[2][:, V:], torch.zeros_like(out[2][:, V:]))


# ---------------------------------------------------------------------------
# K4 and K13 at their edges: the part index's segments over a cached template
# ---------------------------------------------------------------------------

RECON_CACHED_E = {'mano': 10, 'smpl': 10, 'smplx': 17}  # SMPL-X with the kid column
RECON_CACHED_BATCHES = [1000, 4097]  # B % 4 != 0: the 4-byte paths


def _recon_cached_args(name, batch, v_t):
    """K4's operands at a model's widths (BWD_SHAPES, E of RECON_CACHED_E)
    over a part index of parts of 1, 63 and 513 vertices and every 11th
    vertex in none, targets of v_t rows: (tgt, pj, x, sd, homog, parts, w)."""
    V, J, _ = BWD_SHAPES[name]
    E = RECON_CACHED_E[name]
    w = _skinning(V + E, V, J, False)
    vp = w.shape[0]
    parts = lbs_kernels.PartIndex.from_membership(_parts(V, J), 'cuda', weights=w.cpu().numpy())
    seed = 10 * V + batch
    return (_normal(seed, 3, v_t, batch), _normal(seed + 1, 12, J, batch, scale=0.5),
            _normal(seed + 2, E, batch), _normal(seed + 3, 3, vp, E, scale=0.05),
            _normal(seed + 4, 3, vp, batch), parts, w)


def _static_omega(V, vp, seed):
    om = np.random.default_rng(seed).uniform(0.1, 2.0, (vp, 1))
    om[::5] = 0.0
    om[V:] = 0.0
    return torch.as_tensor(om, dtype=torch.float32, device='cuda')


@pytest.mark.parametrize('omega', [None, 'static', 'call'])
@pytest.mark.parametrize('name', list(RECON_CACHED_E))
def test_recon_part_sums_cached_kernel_at_edges(card, name, omega):
    """K4 unweighted and in both ω forms on seeded operands at MANO, SMPL and
    SMPL-X widths (E = 17), targets of all V rows and of fewer: within
    REL_TOL of the twin and bit for bit on a repeat at every batch of
    RECON_CACHED_BATCHES."""
    V = BWD_SHAPES[name][0]
    for batch, v_t in zip(RECON_CACHED_BATCHES, (V, V - 37)):
        args = _recon_cached_args(name, batch, v_t)
        kw = {}
        if omega == 'static':
            kw['omega'] = _static_omega(V, args[6].shape[0], batch)
        elif omega == 'call':
            om = np.random.default_rng(batch).uniform(0.1, 2.0, (v_t, batch))
            om[::5] = 0.0
            kw['omega'] = torch.as_tensor(om, dtype=torch.float32, device='cuda')
        _hold_all('recon_part_sums_cached_lm', args, kw,
                  'recon_part_sums_cached' + ('' if omega is None else '_w'))


@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('name', list(RECON_CACHED_E))
def test_recon_part_sums_cached_bwd_kernel_at_edges(card, name, omega):
    """K13 (unweighted and static ω) on K4's operands at MANO, SMPL and
    SMPL-X widths (J = 55, E = 17), targets of all V rows and of fewer:
    within REL_TOL of the twin and bit for bit on a repeat at every batch of
    RECON_CACHED_BATCHES, the rows in no part zero in dtgt and dh."""
    V, J, _ = BWD_SHAPES[name]
    for batch, v_t in zip(RECON_CACHED_BATCHES, (V, V - 37)):
        tgt, pj, x, sd, homog, parts, w = _recon_cached_args(name, batch, v_t)
        kw = dict(omega=_static_omega(V, w.shape[0], batch)) if omega else {}
        seed = 10 * V + batch + 5
        args = (_normal(seed, 9, J, batch), _normal(seed + 1, 3, J, batch),
                _normal(seed + 2, 3, J, batch), tgt, pj, x, sd, homog, parts, w)
        dtgt, _, _, dh = _hold_all('recon_part_sums_cached_bwd', args, kw,
                                   'recon_part_sums_cached_bwd' + ('_w' if omega else ''))
        none = parts.unused.long()
        assert torch.equal(dh[:, none], torch.zeros_like(dh[:, none]))
        none = none[none < v_t]
        assert torch.equal(dtgt[:, none], torch.zeros_like(dtgt[:, none]))


def test_call_weighted_fit_at_32_betas(tmp_path_factory):
    """A per-call weighted fit with E = 32 shape columns (K9 above its old
    limit of 17) runs on the card and matches the CPU: betas within the
    larger of 1e-3 and 4x the fit's own spread (as phase 12 of chip_smoke)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    d = str(tmp_path_factory.mktemp('body_models_32'))
    synthetic.write_model_files(d, 'smpl', 1000, num_betas=32)
    bm = BodyModel('smpl', 'neutral', model_root=d + '/smpl', device='cuda')
    fitter = BodyFitter(bm, num_betas=32)
    cpu_fitter = BodyFitter(port_model_from(bm), num_betas=32)
    rng = np.random.default_rng(32)
    pose, _, trans = _params(16, 32)
    betas = rng.normal(0, 1, (16, 32)).astype(np.float32)
    out = bm(pose, betas, trans)
    tv, tj = out['vertices'], out['joints']
    kw = dict(FIT_KW, vertex_weights=_fit_weights(16, bm.num_vertices, 5),
              joint_weights=_fit_weights(16, bm.num_joints, 6))
    lbs_kernels.reset_launch_counts()
    card = fitter.fit(tv, tj, **kw)
    assert lbs_kernels.LAUNCHES['wgram'] == 3
    cpu = cpu_fitter.fit(tv.cpu(), tj.cpu(), **kw)
    spread = max(_own_spread(lambda a, b: cpu_fitter.fit(a, b, **kw), tv.cpu(), tj.cpu(), cpu),
                 _own_spread(lambda a, b: fitter.fit(a, b, **kw), tv, tj, card))
    assert _max_dbetas(card, cpu) <= max(1e-3, 4 * spread)


# ---------------------------------------------------------------------------
# share_beta, the ragged fit function and vertex subsets
# ---------------------------------------------------------------------------


def _shared_targets(bm, batch, seed):
    """Targets of one shape in ``batch`` poses."""
    pose, betas, trans = _params(batch, seed)
    out = bm(pose, np.repeat(betas[:1], batch, axis=0), trans)
    return out['vertices'], out['joints']


def test_share_beta_card_fit_matches_cpu_fit(card_models):
    """The SMPL headline fit with share_beta at B=32: the twin's launches,
    one shape on every row, and the CPU's betas within 1e-3."""
    bm, fitter = card_models
    tv, tj = _shared_targets(bm, 32, 7)
    kw = dict(FIT_KW, share_beta=True)
    lbs_kernels.reset_launch_counts()
    card = fitter.fit(tv, tj, **kw)
    for key in ('rhs_moments_h', 'gram_assembly', 'recon_part_sums_cached'):
        assert lbs_kernels.LAUNCHES[key] == 3, key
    assert torch.equal(card['shape_betas'], card['shape_betas'][:1].expand(32, -1))
    cpu = BodyFitter(port_model_from(bm)).fit(tv.cpu(), tj.cpu(), **kw)
    assert (card['shape_betas'].cpu() - cpu['shape_betas']).abs().max().item() <= 1e-3
    for key in ('pose_rotvecs', 'trans'):
        assert torch.allclose(card[key].cpu(), cpu[key], atol=1e-3), key


def test_ragged_card_fit_matches_cpu_fit(tmp_path, monkeypatch):
    """``get_cached_fit_fn(share_beta=True).ragged`` on sequences of 9, 3 and
    15 frames (a bucket of 32) on the card and on the CPU: betas within 1e-3,
    each sequence's results its own length."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    synthetic.write_model_files(str(tmp_path), 'smpl', 1000)
    monkeypatch.setenv('SMPLFITTER_BODY_MODELS', str(tmp_path))
    card_fn = get_cached_fit_fn('smpl', share_beta=True, device='cuda')
    cpu_fn = get_cached_fit_fn('smpl', share_beta=True, device='cpu')
    bm = BodyModel('smpl', 'neutral', model_root=str(tmp_path / 'smpl'), device='cuda')
    tv, tj = _shared_targets(bm, 27, 8)
    cuts = [0, 9, 12, 27]
    seqs = [(tv[a:b], tj[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    card = card_fn.ragged([s[0] for s in seqs], [s[1] for s in seqs])
    cpu = cpu_fn.ragged([s[0].cpu() for s in seqs], [s[1].cpu() for s in seqs])
    assert [len(x) for x in card['shape_betas']] == [9, 3, 15]
    betas_card, betas_cpu = torch.cat(card['shape_betas']), torch.cat(cpu['shape_betas'])
    assert torch.equal(betas_card, betas_card[:1].expand(27, -1))
    assert (betas_card.cpu() - betas_cpu).abs().max().item() <= 1e-3
    for key in ('pose_rotvecs', 'trans'):
        assert torch.allclose(torch.cat(card[key]).cpu(), torch.cat(cpu[key]), atol=1e-3), key


SUBSET_V = 870  # 870 % 32 = 6, 870 % 256 = 102
EMPTY_PART = 22  # the left hand, a leaf part


@pytest.fixture(scope='module')
def subset_fitters(tmp_path_factory):
    """The fitters of a subset of the synthetic SMPL (V = 1000) with no vertex
    in leaf part EMPTY_PART, as chip_smoke.capture_forms takes them."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    d = str(tmp_path_factory.mktemp('body_models_subset'))
    synthetic.write_model_files(d, 'smpl', 1000)
    full = BodyModel('smpl', 'neutral', model_root=d + '/smpl', device='cpu')
    part = np.argmax(np.asarray(full.model_data.weights), axis=1)
    subset = np.sort(np.random.default_rng(3).choice(np.nonzero(part != EMPTY_PART)[0],
                                                     SUBSET_V, replace=False))
    bm = BodyModel('smpl', 'neutral', model_root=d + '/smpl', vertex_subset=subset,
                   device='cuda')
    fitter = BodyFitter(bm)
    fs = weighted_fitters(smplfitter_tpu_torch, bm, 'smpl', np.random.default_rng(4), fitter)
    fs['kid'] = BodyFitter(bm, enable_kid=True)
    part_seg = fitter.plan.part_seg.tolist()
    assert part_seg[EMPTY_PART + 1] == part_seg[EMPTY_PART]
    return bm, fs


@pytest.mark.parametrize('batch', [1, 33, 4097])
def test_subset_kernels_at_edges(subset_fitters, batch):
    """Every kernel form of the fitting paths (K1-K15, the large-F forms on
    derived operands) on the subset: within REL_TOL of its twin, bit for bit
    on a repeat, and the rows in no part zero in the backward kernels' target
    cotangent. At B = 1 the rotation fits take a one-column mesh as a
    batch-constant reference (one GEMM), so K5 and K15 are held at 33 and
    4097 only."""
    bm, fs = subset_fitters
    rng = np.random.default_rng(batch)
    params = [torch.as_tensor(x, device='cuda') for x in _params(batch, batch)]
    kid = torch.as_tensor(rng.normal(0, 0.5, batch).astype(np.float32), device='cuda')
    vw, jw = (torch.as_tensor(rng.uniform(0.1, 2.0, (batch, n)).astype(np.float32),
                              device='cuda') for n in (bm.num_vertices, bm.num_joints))
    required = CAPTURED['smpl'] | BWD_CAPTURED['smpl']
    if batch == 1:  # a one-column mesh takes the batch-constant reference's GEMM, not K5
        required -= {'part_sums', 'part_sums_bwd', 'part_sums_bwd_w'}
    forms = capture_forms(torch, lbs_kernels, bm, fs, params, kid, vw, jw, required)
    assert not any(lbs_kernels.HOST_COVERS.values())
    unused = fs['plain'].plan.part_unused.long()
    for key, calls in forms.items():
        args, kw = calls[0]
        got = _hold_all(SPECS[key][0], args, kw, key)
        if key.startswith(('recon_part_sums_bwd', 'recon_part_sums_cached_bwd', 'part_sums_bwd')):
            rows = unused[unused < got[0].shape[1]]
            assert torch.equal(got[0][:, rows], torch.zeros_like(got[0][:, rows])), key


@pytest.fixture(scope='module')
def app_models(tmp_path_factory):
    """SMPL (V=500) and SMPL-X (V=700) of a synthetic full environment, on
    the card and on the CPU, with DATA_ROOT pointing at it."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import os

    d = str(tmp_path_factory.mktemp('apps') / 'body_models')
    synthetic.write_full_test_environment(d, 500, 700)
    saved = {k: os.environ.get(k) for k in ('SMPLFITTER_BODY_MODELS', 'DATA_ROOT')}
    os.environ['SMPLFITTER_BODY_MODELS'] = d
    os.environ['DATA_ROOT'] = os.path.dirname(d)
    card = {n: BodyModel(n, 'neutral', device='cuda') for n in ('smpl', 'smplx')}
    yield card, {n: port_model_from(bm) for n, bm in card.items()}
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _app_inputs(model, batch, seed):
    rng = np.random.default_rng(seed)
    J, S = {'smpl': (24, 10), 'smplx': (55, 16)}[model]
    return tuple(torch.as_tensor(x, device='cuda') for x in (
        rng.normal(0, 0.2, (batch, 3 * J)).astype(np.float32),
        rng.normal(0, 1, (batch, S)).astype(np.float32),
        rng.normal(0, 0.5, (batch, 3)).astype(np.float32)))


def _launches_of(call, n_calls=1):
    call()
    torch.cuda.synchronize()
    lbs_kernels.reset_launch_counts()
    for _ in range(n_calls):
        call()
    torch.cuda.synchronize()
    assert not any(lbs_kernels.TORCH_VJPS.values())
    assert not any(lbs_kernels.HOST_COVERS.values())
    return {k: n for k, n in lbs_kernels.LAUNCHES.items() if n}


def test_converter_card_matches_cpu(app_models):
    """SMPL-X -> SMPL (free route, num_iter=1) on the card against the CPU
    port under bench.py's gate (betas 1e-3, v2v 0.01 mm), and its launches."""
    card, cpu = app_models
    convs = (smplfitter_tpu_torch.BodyConverter(card['smplx'], card['smpl']),
             smplfitter_tpu_torch.BodyConverter(cpu['smplx'], cpu['smpl']))
    p = _app_inputs('smplx', 33, 90)
    target = convs[1].convert_vertices(cpu['smplx'](*[x.cpu() for x in p])['vertices'])
    failures = []
    app_parity('convert smplx->smpl', lambda c, *q: c.convert(*q, num_iter=1), convs, p,
               ('shape_betas',), failures, spread_rule=False,
               v2v=lambda r: params_v2v_mm(cpu['smpl'], r, target))
    assert not failures
    assert _launches_of(lambda: convs[0].convert(*p, num_iter=1)) == \
        APP_LAUNCHES['convert smplx->smpl']


def test_flipper_card_matches_cpu(app_models):
    """SMPL's flip (the SMPL-X correspondence composed through the deftrafo
    transfers, path (b)'s fit) on the card against the CPU port under
    bench.py's gate; the mirror maps equal."""
    card, cpu = app_models
    flips = (smplfitter_tpu_torch.BodyFlipper(card['smpl']),
             smplfitter_tpu_torch.BodyFlipper(cpu['smpl']))
    assert torch.equal(flips[0].mirror_inds.cpu(), flips[1].mirror_inds)
    p = _app_inputs('smpl', 33, 91)
    target = flips[1].flip_vertices(cpu['smpl'](*[x.cpu() for x in p])['vertices'])
    failures = []
    app_parity('flip smpl', lambda f, *q: f.flip(*q), flips, p, ('shape_betas', 'kid_factor'),
               failures, spread_rule=False, v2v=lambda r: params_v2v_mm(cpu['smpl'], r, target))
    assert not failures


def test_refiner_card_matches_cpu(app_models):
    """10 Adam steps of BodyFitterOpt on the card against the CPU port:
    every output within the larger of 1e-3 and 4x its own spread, the loss
    within 1e-4 relative (chip_smoke.app_parity); one K1 and one K10 per
    step and no torch-op backward pass."""
    card, cpu = app_models
    opts = (smplfitter_tpu_torch.BodyFitterOpt(card['smpl']),
            smplfitter_tpu_torch.BodyFitterOpt(cpu['smpl']))
    out = card['smpl'](*_app_inputs('smpl', 33, 92))
    tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
    kw = dict(num_iter=3, beta_regularizer=1.0, refine_steps=10, refine_lr=0.01)
    failures = []
    app_parity('refine smpl', lambda o, v, j: o.fit(v, j, **kw), opts, (tv, tj),
               ('pose_rotvecs', 'shape_betas', 'trans'), failures, spread_rule=True,
               loss=lambda r: refine_loss(cpu['smpl'], r, tv.cpu(), tj.cpu()))
    assert not failures
    launches = _launches_of(lambda: opts[0].fit(tv, tj, **kw))
    assert launches == dict(APP_LAUNCHES['refine smpl'], lbs_points=10, lbs_points_bwd=10)



# --- the tooling: the parity check, precompile, sharding, regressor training ---


@pytest.fixture(scope='module')
def smpl_root_432(tmp_path_factory):
    """A synthetic SMPL at the CPU tests' width (V=432), its model directory."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    d = str(tmp_path_factory.mktemp('body_models_432'))
    synthetic.write_model_files(d, 'smpl', 432)
    return os.path.join(d, 'smpl')


@pytest.mark.parametrize('model', ['smpl', 'smplx'])
def test_check_kernel_parity(card_models, smplx_models, model):
    """check_kernel_parity at its defaults: ok on SMPL; on SMPL-X max|d betas|
    within the larger of 1e-3 and SPREAD_MULT x the card fit's own spread
    (phase 10's rule: the rotation fits amplify f32 rounding on the hands),
    the mean reconstruction errors within 0.05 mm."""
    fitter = card_models[1] if model == 'smpl' else smplx_models[1]
    rep = fitter.check_kernel_parity(raise_on_fail=False)
    assert set(rep) == {'ok', 'max_dbetas', 'v2v_kernel_mm', 'v2v_xla_mm'}
    assert np.isfinite([rep['max_dbetas'], rep['v2v_kernel_mm'], rep['v2v_xla_mm']]).all()
    if model == 'smpl':
        assert rep['ok'], rep
    else:
        limit = max(1e-3, SPREAD_MULT * parity_spread(torch, fitter))
        assert rep['max_dbetas'] <= limit, (rep, limit)
        assert abs(rep['v2v_kernel_mm'] - rep['v2v_xla_mm']) <= 0.05, rep


def test_precompile_warm_checks_parity(smpl_root_432, capsys):
    from smplfitter_tpu_torch import precompile

    precompile.warm(model_root=smpl_root_432, batch_sizes=(32,), check_parity=True)
    out = capsys.readouterr().out
    assert 'kernel library' in out and 'batch 32: forward and fit' in out
    assert 'kernel parity: ok=True' in out, out


@pytest.mark.parametrize('share_beta', [False, True])
def test_sharded_fit_on_one_nccl_rank_is_the_fit(card_models, tmp_path, share_beta):
    """make_sharded_fit_fn on an NCCL group of one rank at B=32 equals the
    unsharded fit bit for bit (the shared sums' all-reduce of one rank adds
    nothing), with the headline's launches."""
    import torch.distributed as dist

    from smplfitter_tpu_torch.parallel import sharding

    bm, fitter = card_models
    out = bm(*_params(32, 320))
    tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
    kw = dict(FIT_KW, share_beta=share_beta)
    want = fitter.fit(tv, tj, **kw)
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', init_method=f'file://{tmp_path / "store"}', rank=0,
                            world_size=1)
    try:
        fit = sharding.make_sharded_fit_fn(fitter, **kw)
        launches = _launches_of(lambda: fit(tv, tj))
        got = fit(tv, tj)
    finally:
        dist.destroy_process_group()
    assert launches == dict(rhs_moments_h=3, gram_assembly=3, recon_part_sums_cached=3)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_regressor_training_on_the_card(smpl_root_432):
    """The trainer at the CPU test's sizes on the card: its forward passes
    are K1 (one per step), the rows convex, the regressed joints within 0.1
    of the model's."""
    from smplfitter_tpu_torch.utils import joint_regressor_training as jrt

    bm = BodyModel('smpl', 'neutral', model_root=smpl_root_432, device='cuda')
    subset = np.arange(0, bm.num_vertices, 2)
    lbs_kernels.reset_launch_counts()
    reg = jrt.train_post_lbs_regressor(bm, subset, num_steps=60, finetune_steps=30,
                                       batch_size=16)
    assert lbs_kernels.LAUNCHES['lbs_points'] == 90
    assert reg.shape == (24, len(subset))
    np.testing.assert_allclose(reg.sum(axis=1), 1.0, atol=1e-5)
    assert np.all(reg >= 0)
    res = bm(*_params(4, 81)[:2])
    pred = np.einsum('jv,bvc->bjc', reg, res['vertices'].cpu().numpy()[:, subset])
    err = np.linalg.norm(pred - res['joints'].cpu().numpy(), axis=-1).mean()
    assert err < 0.1, err


def _profiled_fit(fitter, tv, tj):
    """The names of the device events and the spans (by ordinal) of one
    headline fit under ``torch.profiler``. The session starts with a kernel
    of its own and a synchronise, and only device events after that count:
    some sessions lose their first kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device='cuda').add_(1)
        torch.cuda.synchronize()
        fitter.fit(tv, tj, **FIT_KW)
        torch.cuda.synchronize()
    events = prof.events()
    cut = min(e.time_range.end for e in events if e.name == 'cudaDeviceSynchronize')
    device = [e.name for e in events
              if e.device_type == DeviceType.CUDA and e.time_range.start >= cut]
    recs = sorted(profiling.spans(), key=lambda r: r['index'])
    profiling.clear_spans()
    return device, recs


def test_fit_spans_add_no_device_event(card_models, monkeypatch):
    """A B=4096 headline fit under the profiler: its spans give the same
    device events as the fit with the spans made null, none named after a
    span; the stages' stream ms add up to the fit's within 3%, and their
    launches to the fit's and the counters' change."""
    bm, fitter = card_models
    out = bm(*_params(4096, 23))
    tv, tj = out['vertices'], out['joints']
    fitter.fit(tv, tj, **FIT_KW)
    torch.cuda.synchronize()
    before = sum(lbs_kernels.LAUNCHES.values())
    device, recs = _profiled_fit(fitter, tv, tj)
    launched = sum(lbs_kernels.LAUNCHES.values()) - before
    assert [r['name'] for r in recs] == [
        'fit', 'fit.prepare', 'fit.rotations', 'fit.solve', 'fit.rotations', 'fit.solve',
        'fit.rotations', 'fit.solve', 'fit.adjust', 'fit.outputs']
    names = {r['name'] for r in recs}
    assert not [n for n in device if n.split('#')[0] in names]
    fit, stages = recs[0], recs[1:]
    assert fit['launches'] == launched == sum(r['launches'] for r in stages) > 0
    # K2 emit, once per shape solve, by the overlapped loop at this batch.
    assert fit['k2_overlapped'] == 3
    assert [r['k2_overlapped'] for r in stages if r['name'] == 'fit.solve'] == [1, 1, 1]
    stage_ms = sum(r['stream_ms'] for r in stages)
    assert abs(stage_ms - fit['stream_ms']) <= 0.03 * fit['stream_ms'], (stage_ms, fit)
    monkeypatch.setattr(profiling, 'span', lambda name: contextlib.nullcontext())
    device_null, recs_null = _profiled_fit(fitter, tv, tj)
    assert recs_null == []
    assert len(device) == len(device_null) > 0


@pytest.fixture(scope='module')
def refine_cell(tmp_path_factory):
    """The benchmark's ``smplx-refine-grad`` cell at B=1024: its refiner on
    the card and on the CPU, the float64 reference on the card, and one
    input set drawn on the card by the cell's entry."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from types import SimpleNamespace

    from portbench import harness, synth
    from portbench.reference import RefModel
    from smplfitter_tpu_torch.models.bodyfitter_opt import BodyFitterOpt

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = harness.load_cell(root, 'smplx-refine-grad')
    cfg = spec.config
    model_root = synth.ensure_model_files(str(tmp_path_factory.mktemp('bench_models')), cfg)
    opts = [BodyFitterOpt(BodyModel(cfg['model'], cfg['gender'], model_root=model_root,
                                    num_betas=cfg['num_betas'], device=dev))
            for dev in ('cuda', 'cpu')]
    refs = [RefModel(model_root, cfg['model'], cfg['num_betas'], 'cuda', dt)
            for dt in (torch.float32, torch.float64)]
    tr = dict(spec.traffic, batch=1024, target_sets=1)
    ctx = SimpleNamespace(config=cfg, traffic=tr, device='cuda')
    inp = spec.entry.make_inputs(ctx, refs[0], torch.Generator('cuda').manual_seed(2 ** 31 + 9))[0]
    return opts, refs[1], inp, tr


def test_refine_step_on_smplx_matches_cpu_and_reference(refine_cell):
    """``loss_and_grad`` at SMPL-X's published widths, B=1024: each gradient
    on the card within REL_TOL (the CPU tests' 1e-5) x its largest component
    of the CPU port's and of the float64 reference's; one K1 and one K10
    launch; under the profiler, ``refine.loss`` and ``refine.backward``
    cover at least 95% of ``refine``'s stream time, K10's launch counted in
    ``refine.backward``."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.reference_refine import PARAMS, refine_grads

    (card, cpu), ref64, inp, tr = refine_cell
    reg = tr['refine']['beta_regularizer']
    params = {k: inp[k] for k in PARAMS}
    lbs_kernels.reset_launch_counts()
    loss, grads = card.loss_and_grad(params, inp['target_vertices'], inp['target_joints'],
                                     beta_regularizer=reg)
    torch.cuda.synchronize()
    assert {k: n for k, n in lbs_kernels.LAUNCHES.items() if n} == dict(lbs_points=1,
                                                                         lbs_points_bwd=1)
    loss_cpu, grads_cpu = cpu.loss_and_grad({k: v.cpu() for k, v in params.items()},
                                            inp['target_vertices'].cpu(),
                                            inp['target_joints'].cpu(), beta_regularizer=reg)
    want = refine_grads(ref64, params, inp['target_vertices'], inp['target_joints'], 1024, reg)
    for k in PARAMS:
        for other in (grads_cpu[k].double(), want[k].cpu()):
            gap = (grads[k].cpu().double() - other).abs().max().item()
            assert gap <= REL_TOL * other.abs().max().item(), (k, gap)
    assert abs(loss.item() - loss_cpu.item()) <= REL_TOL * loss_cpu.item()

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        card.loss_and_grad(params, inp['target_vertices'], inp['target_joints'],
                           beta_regularizer=reg)
        torch.cuda.synchronize()
    recs = {r['name']: r for r in profiling.spans()}
    profiling.clear_spans()
    assert set(recs) == {'refine', 'refine.loss', 'forward', 'refine.backward'}
    assert recs['refine.loss']['launches'] == recs['refine.backward']['launches'] == 1
    parts = recs['refine.loss']['stream_ms'] + recs['refine.backward']['stream_ms']
    # Events time to about a microsecond: the parts may read that much over.
    assert 0.95 * recs['refine']['stream_ms'] <= parts <= recs['refine']['stream_ms'] + 1e-2
