"""Gradients through the port's forward pass and fit against the JAX package
on the CPU.

Synthetic SMPL (V=432) and SMPL-X (V=660, J=55, F=487) from the suite's
body_models directory; inputs made from numpy seeds and handed to both
packages.

- The forward pass: the gradient of sum(sin(vertices)) in pose, betas and
  translation against jax.grad of the JAX forward, within 2e-5 x max|g_jax|
  (f32 on both sides, other summation orders; the forward's own tolerance).
- ``smplfitter_tpu_torch.get_fit_grad_fn`` against the JAX package's
  ``get_fit_grad_fn`` (``use_kernels=False``, jitted, computed once per
  model): SMPL in the headline configuration (num_iter=3, final adjustment),
  SMPL-X with num_iter=1, whose gradient runs through K7's, K12's and the
  streamed Gramian term's backward. Value within 1e-4 relative (SMPL-X's
  nearly degenerate finger parts move it by 1.3e-5 between the packages),
  gradients within 1e-3 x max|g_jax| (the JAX package's own limit for its kernel
  gradient, tests/test_tpu_grad.py; the gap measured 3.6e-5 before the
  backward kernels existed).
- Chunked against monolithic (the fits are independent per instance), and the
  backward twins each gradient reaches.
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
from smplfitter_tpu_torch.api import default_loss
from smplfitter_tpu_torch.ops import lbs_kernels as port_k

BATCH = 8
# model -> (joints, betas, pose std, num_iter of the gradient)
SHAPES = {'smpl': (24, 10, 0.1, 3), 'smplx': (55, 16, 0.1, 1)}
GRAD_REL_TOL = 1e-3


@pytest.fixture(scope='module')
def models(body_models_dir):
    out = {}
    for name in SHAPES:
        jax_bm = smplfitter_tpu.BodyModel(name, 'neutral')
        bm = port_model_from(jax_bm)
        out[name] = (jax_bm, smplfitter_tpu.BodyFitter(jax_bm), bm,
                     smplfitter_tpu_torch.BodyFitter(bm))
    return out


def _params(name, seed):
    J, S, pose_std, _ = SHAPES[name]
    rng = np.random.default_rng(seed)
    return (rng.normal(0, pose_std, (BATCH, 3 * J)).astype(np.float32),
            rng.normal(0, 1, (BATCH, S)).astype(np.float32),
            rng.normal(0, 0.5, (BATCH, 3)).astype(np.float32))


def _targets(jax_bm, name, seed):
    pose, betas, trans = _params(name, seed)
    out = jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    return np.asarray(out['vertices']), np.asarray(out['joints'])


@pytest.fixture(scope='module')
def jax_fit_grads(models):
    """The JAX package's value and gradient of the default loss per model,
    each computed once (jitted) on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jax_bm, jax_fitter = models[name][:2]
            tv, tj = _targets(jax_bm, name, seed=20)
            vg = smplfitter_tpu.get_fit_grad_fn(jax_fitter, num_iter=SHAPES[name][3],
                                                use_kernels=False)
            value, (g_tv, g_tj) = vg(jnp.asarray(tv), jnp.asarray(tj))
            cache[name] = (tv, tj, float(value), np.asarray(g_tv), np.asarray(g_tj))
        return cache[name]

    return get


def _close(ours, theirs, rel):
    ours, theirs = ours.detach().numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * np.abs(theirs).max())


@pytest.mark.parametrize('name', list(SHAPES))
def test_forward_gradient_matches_jax(models, name):
    jax_bm, _, bm, _ = models[name]
    params = _params(name, seed=21)

    def loss(pose, betas, trans):
        return jnp.sum(jnp.sin(jax_bm(pose_rotvecs=pose, shape_betas=betas,
                                      trans=trans)['vertices']))

    theirs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, params))
    xs = [torch.as_tensor(p).requires_grad_() for p in params]
    ours = torch.autograd.grad(torch.sin(bm(*xs)['vertices']).sum(), xs)
    for o, t in zip(ours, theirs):
        _close(o, t, 2e-5)


@pytest.mark.parametrize('name', list(SHAPES))
def test_fit_gradient_matches_jax(models, jax_fit_grads, name):
    fitter = models[name][3]
    tv, tj, value, g_tv, g_tj = jax_fit_grads(name)
    vg = smplfitter_tpu_torch.get_fit_grad_fn(fitter, num_iter=SHAPES[name][3])
    ours_value, (ours_tv, ours_tj) = vg(tv, tj)
    assert ours_value.shape == ()
    np.testing.assert_allclose(ours_value.item(), value, rtol=1e-4)
    for o, t in ((ours_tv, g_tv), (ours_tj, g_tj)):
        assert torch.isfinite(o).all() and o.abs().max() > 0
        _close(o, t, GRAD_REL_TOL)


def test_chunked_matches_monolithic(models):
    """The analogue of tests/test_gradients.py::TestGetFitGradFn: the summed
    loss and its gradient decompose over batch chunks. The chunks run the
    same per-instance arithmetic, but the CPU's batched products round by
    batch size: 1e-4 x max|g| (2.3e-5 measured)."""
    jax_bm, _, _, fitter = models['smpl']
    tv, tj = _targets(jax_bm, 'smpl', seed=22)
    kw = dict(num_iter=2, final_adjust_rots=False)
    v_m, (g_tv_m, g_tj_m) = smplfitter_tpu_torch.get_fit_grad_fn(fitter, **kw)(tv, tj)
    v_c, (g_tv_c, g_tj_c) = smplfitter_tpu_torch.get_fit_grad_fn(fitter, chunk=4, **kw)(tv, tj)
    np.testing.assert_allclose(v_c.item(), v_m.item(), rtol=1e-5)
    for c, m in ((g_tv_c, g_tv_m), (g_tj_c, g_tj_m)):
        assert c.abs().max() > 0
        _close(c, m.numpy(), 1e-4)


def test_custom_loss(models):
    """``loss_fn`` replaces the default loss: twice the default loss gives
    twice the value and gradient."""
    jax_bm, _, _, fitter = models['smpl']
    tv, tj = _targets(jax_bm, 'smpl', seed=23)
    kw = dict(num_iter=1, final_adjust_rots=False)
    v, (g_tv, g_tj) = smplfitter_tpu_torch.get_fit_grad_fn(fitter, **kw)(tv, tj)

    v2, (g2_tv, g2_tj) = smplfitter_tpu_torch.get_fit_grad_fn(
        fitter, loss_fn=lambda res: 2 * default_loss(res), **kw)(tv, tj)
    torch.testing.assert_close(v2, 2 * v)
    torch.testing.assert_close(g2_tv, 2 * g_tv)
    torch.testing.assert_close(g2_tj, 2 * g_tj)


@pytest.mark.parametrize('name, expected', [
    ('smpl', dict(rhs_moments_bwd=3, recon_part_sums_cached_bwd=3)),
    ('smplx', dict(rhs_moments_cached_bwd=3, recon_part_sums_cached_bwd=3)),
])
def test_fit_gradient_reaches_the_backward_twins(models, name, expected, monkeypatch):
    """On the CPU the headline fit's gradient runs the backward twins the
    card runs as kernels: K11 (with the emitted template's cotangent) or K12
    once per solve, K13 once per rotation fit on the cache."""
    jax_bm, _, _, fitter = models[name]
    counts = dict.fromkeys(expected, 0)
    for wrapper in expected:
        original = getattr(port_k, wrapper)

        def counted(*args, _wrapper=wrapper, _original=original, **kwargs):
            counts[_wrapper] += 1
            if _wrapper == 'rhs_moments_bwd':
                assert kwargs['gh'] is not None
            return _original(*args, **kwargs)

        monkeypatch.setattr(port_k, wrapper, counted)
    tv, tj = _targets(jax_bm, name, seed=24)
    smplfitter_tpu_torch.get_fit_grad_fn(fitter)(tv, tj)
    assert counts == expected
