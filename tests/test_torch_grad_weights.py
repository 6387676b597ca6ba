"""Gradients of the port's kernel forms that have no backward kernel in the
JAX package, and of the fits that run them, against the JAX package on the
CPU; finite-difference probes and the backward passes each gradient path
reaches.

The JAX package gives K2's scale forms, per-call fit weights on K4, K5 and
K6, and K9 (``wgram_moments``) no custom VJP and differentiates them through
its XLA formulation. The port keeps their forward kernels and takes their
backward in torch ops: the VJP of the twin's formula, recomputed one vertex
chunk at a time (``lbs_kernels._ChunkedVjp``), counted in
``lbs_kernels.TORCH_VJPS``.

- Each such Function against autograd of its twin under random cotangents,
  with every operand requiring grad: the targets, [R|t] entries, features or
  cached template, K9's Jacobian operands and means, and the weights get the
  twin's gradients within 1e-5 x max|g|; the skinning weights, templates and
  shape directions get None. The vertex chunk is cut to 100 so that several
  chunks, the last one partial, add up.
- Fit gradients against ``jax.grad`` of the JAX fit with ``use_kernels=False``
  (each JAX reference jitted once): a per-call weighted fit without joints
  (one iteration: K5 and K9 with per-call ω, gradients in the targets and
  the weights) and a static-weight ``scale_fit`` without joints (K2's scale
  form with ω, K15ω), on the synthetic SMPL (V=432), B=8: value within 1e-4
  relative, gradients within 1e-3 x max|g_jax|.
- A port version of tests/test_gradients.py's random-direction
  finite-difference probe (rtol 0.12, atol 1e-3) on the headline fit and on
  four newly differentiable paths.
- Each of ``chip_smoke.GRAD_PATHS``' gradients on the CPU calls the backward
  twins and torch-op backward passes that its counts say the card launches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_on_cpu
import smplfitter_tpu
import smplfitter_tpu_torch
from chip_smoke import (BWD_WRAPPERS, GRAD_PATHS, WRAPPERS, bwd_key, fit_weights,
                        grad_path_counts, kernel_key, path_vg, random_params, record_calls,
                        weighted_fitters)
from smplfitter_tpu_torch.ops import lbs_kernels as port_k

BATCH = 8
REL_TOL = 1e-5
GRAD_REL_TOL = 1e-3
VALUE_RTOL = 1e-4


def _leaf(t):
    return t.detach().clone().requires_grad_()


def _close(ours, theirs, rel):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs.detach() if isinstance(theirs, torch.Tensor) else theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * np.abs(theirs).max())


# ---------------------------------------------------------------------------
# The torch-op backward passes against autograd of their twins
# ---------------------------------------------------------------------------


def _operands():
    """Small operands of every form (V_pad 512, V_t 430, J 4, B 3, E 2, F 5):
    the static ω column zero past V_t, weights positive."""
    rng = np.random.default_rng(50)
    Vp, Vt, J, B, E, F = 512, 430, 4, 3, 2, 5

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    pm = np.zeros((J, Vp), np.float32)
    pm[rng.integers(0, J, Vt), np.arange(Vt)] = 1.0
    pm[:, :7] = 0.0  # vertices outside every part
    om_static = np.zeros((Vp, 1), np.float32)
    om_static[:Vt] = rng.uniform(0.1, 2.0, (Vt, 1))
    return dict(tgt=t(3, Vt, B), pj=t(12, J, B), feat=t(F, B), w=t(Vp, J), consts=t(4, Vp, F),
                sd=t(3, Vp, E), homog=t(3, Vp, B), x=t(E, B), a=t(3, Vp, B), a1=t(3, Vp, 1),
                om_call=torch.as_tensor(rng.uniform(0.1, 2.0, (Vt, B)).astype(np.float32)),
                om_static=torch.as_tensor(om_static), t4=t(3 * E, J, B), mu=t(3 * E, B),
                mu_s=t(3, B), parts=port_k.PartIndex.from_membership(pm, 'cpu'))


def _rhs(cached, omega):
    def fn(o):
        ops = (o['tgt'], o['pj'], None if cached else o['feat'], o['w'],
               None if cached else o['consts'], o['sd'], o['homog'] if cached else None,
               o['om_static'] if omega else None)
        name = ('rhs_moments_cached_scale' if cached else 'rhs_moments_scale') + (
            '_w' if omega else '')
        twin = (lambda t, p, f, w, c, s, h, om: port_k.rhs_moments_cached_ref(
            t, p, h, w, s, scale=True, omega=om)) if cached else (
            lambda t, p, f, w, c, s, h, om: port_k.rhs_moments_ref(
                t, p, f, w, c, s, scale=True, omega=om))
        diff = ((0, 1, 6) if cached else (0, 1, 2)) + ((7,) if omega else ())
        return lambda *xs: port_k._rhs_scale_vjp(name, *xs), twin, ops, diff, name
    return fn


def _part_sums_call(bcast):
    def fn(o):
        parts = o['parts']
        return (lambda t, a, om: port_k._part_sums_call_vjp('part_sums_w', t, a, parts, om),
                lambda t, a, om: port_k.part_sums_ref(t, a, parts.pm, omega=om),
                (o['tgt'], o['a1'] if bcast else o['a'], o['om_call']), (0, 1, 2),
                'part_sums_call_w')
    return fn


def _recon_cached_call(o):
    parts = o['parts']
    return (lambda t, p, x, s, h, w, om: port_k._recon_cached_call_vjp(
                'recon_part_sums_cached_w', t, p, x, s, h, parts, w, om),
            lambda t, p, x, s, h, w, om: port_k.recon_part_sums_cached_ref(
                t, p, x, s, h, parts.pm, w, omega=om),
            (o['tgt'], o['pj'], o['x'], o['sd'], o['homog'], o['w'], o['om_call']),
            (0, 1, 2, 4, 6), 'recon_part_sums_cached_call_w')


def _recon_call(o):
    parts = o['parts']
    return (lambda t, p, f, w, c, om: port_k._recon_call_vjp('recon_part_sums_w', t, p, f, w, c,
                                                             parts, om),
            lambda t, p, f, w, c, om: port_k.recon_part_sums_ref(t, p, f, w, c, parts.pm,
                                                                 omega=om),
            (o['tgt'], o['pj'], o['feat'], o['w'], o['consts'], o['om_call']), (0, 1, 2, 5),
            'recon_part_sums_call_w')


def _wgram(mode):
    def fn(o):
        Vt = o['tgt'].shape[1]
        ops = (o['tgt'], o['pj'], o['homog'], o['t4'], o['w'], o['sd'], o['mu'],
               o['om_call'][:Vt], o['mu_s'] if mode else None)
        return (lambda *xs: port_k._wgram_vjp(*xs, scale_mode=mode),
                lambda *xs: port_k.wgram_moments_ref(*xs, scale_mode=mode), ops,
                (0, 1, 2, 3, 6, 7) + ((8,) if mode else ()), 'wgram')
    return fn


TORCH_VJP_FORMS = {
    'rhs_moments_scale': _rhs(False, False),
    'rhs_moments_scale_w': _rhs(False, True),
    'rhs_moments_cached_scale': _rhs(True, False),
    'rhs_moments_cached_scale_w': _rhs(True, True),
    'part_sums_call_w': _part_sums_call(False),
    'part_sums_call_w_batch_constant': _part_sums_call(True),
    'recon_part_sums_cached_call_w': _recon_cached_call,
    'recon_part_sums_call_w': _recon_call,
    'wgram': _wgram(0),
    'wgram_scale_target': _wgram(1),
    'wgram_scale_fit': _wgram(2),
}


@pytest.mark.parametrize('form', list(TORCH_VJP_FORMS))
def test_torch_vjp_matches_autograd_of_twin(monkeypatch, form):
    monkeypatch.setattr(port_k, '_VJP_VCHUNK', 100)
    fn, twin, operands, diff, key = TORCH_VJP_FORMS[form](_operands())
    xs = [None if t is None else _leaf(t) for t in operands]
    port_k.reset_launch_counts()
    outs = fn(*xs)
    gen = torch.Generator().manual_seed(51)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    live = [i for i, x in enumerate(xs) if x is not None]
    got = dict(zip(live, torch.autograd.grad(outs, [xs[i] for i in live], cots,
                                             allow_unused=True)))
    assert port_k.TORCH_VJPS[key] == 1
    ys = [None if t is None else _leaf(t) for t in operands]
    want = torch.autograd.grad(twin(*ys), [ys[i] for i in diff], cots)
    for i in live:
        if i not in diff:
            assert got[i] is None, f'{form}: constant operand {i} got a gradient'
    for i, t in zip(diff, want):
        _close(got[i], t, REL_TOL)


# ---------------------------------------------------------------------------
# Fit gradients against the JAX package
# ---------------------------------------------------------------------------

# path -> (fitter's static vertex weights, the fit's keyword arguments)
WEIGHTED_PATHS = {
    'call_weights_no_joints': (False, dict(num_iter=1, final_adjust_rots=True)),
    'static_scale_fit_no_joints': (True, dict(num_iter=1, scale_fit=True,
                                              final_adjust_rots=True)),
}
LOSS_KEYS = ('shape_betas', 'trans', 'pose_rotvecs', 'scale_corr')


@pytest.fixture(scope='module')
def smpl_pair(body_models_dir):
    jax_bm = smplfitter_tpu.BodyModel('smpl', 'neutral')
    return jax_bm, port_on_cpu.port_model_from(jax_bm)


def _weighted_inputs(jax_bm):
    rng = np.random.default_rng(52)
    pose, betas, trans = random_params(rng, BATCH)
    tv = np.asarray(jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)['vertices'])
    vw = rng.uniform(0.1, 2.0, (BATCH, jax_bm.num_vertices)).astype(np.float32)
    static_vw = rng.uniform(0.1, 2.0, jax_bm.num_vertices).astype(np.float32)
    return tv, vw, static_vw


def _loss(res, xp):
    return sum(xp.sum(res[k] ** 2) for k in LOSS_KEYS if k in res)


@pytest.fixture(scope='module')
def jax_weighted_grads(smpl_pair):
    """path -> the JAX package's value and gradients (in tv, and in the
    per-call weights where the path takes them), jitted once on first use."""
    cache = {}

    def get(path):
        if path not in cache:
            jax_bm = smpl_pair[0]
            tv, vw, static_vw = _weighted_inputs(jax_bm)
            static, kw = WEIGHTED_PATHS[path]
            fitter = smplfitter_tpu.BodyFitter(jax_bm, vertex_weights=static_vw if static
                                               else None)

            def loss(tv_, vw_):
                res = fitter.fit(tv_, vertex_weights=None if static else vw_, use_kernels=False,
                                 requested_keys=('pose_rotvecs',), **kw)
                return _loss(res, jnp)

            argnums = (0,) if static else (0, 1)
            value, grads = jax.jit(jax.value_and_grad(loss, argnums=argnums))(
                jnp.asarray(tv), jnp.asarray(vw))
            cache[path] = (float(value), [np.asarray(g) for g in grads])
        return cache[path]

    return get


@pytest.mark.parametrize('path', list(WEIGHTED_PATHS))
def test_weighted_fit_gradient_matches_jax(smpl_pair, jax_weighted_grads, path):
    """The per-call weighted fit differentiates K5 (batch-constant reference)
    and K9 in torch ops, with the weights' gradient; the static-weight
    ``scale_fit`` K2's scale form with ω in torch ops and K15ω."""
    jax_bm, bm = smpl_pair
    tv, vw, static_vw = _weighted_inputs(jax_bm)
    static, kw = WEIGHTED_PATHS[path]
    fitter = smplfitter_tpu_torch.BodyFitter(bm, vertex_weights=static_vw if static else None)
    tv_t, vw_t = torch.tensor(tv).requires_grad_(), torch.tensor(vw).requires_grad_()
    port_k.reset_launch_counts()
    res = fitter.fit(tv_t, vertex_weights=None if static else vw_t,
                     requested_keys=('pose_rotvecs',), **kw)
    loss = _loss(res, torch)
    ours = torch.autograd.grad(loss, (tv_t,) if static else (tv_t, vw_t))
    key = 'rhs_moments_scale_w' if static else 'wgram'
    assert port_k.TORCH_VJPS[key] == 1
    value, theirs = jax_weighted_grads(path)
    np.testing.assert_allclose(loss.item(), value, rtol=VALUE_RTOL)
    for o, t in zip(ours, theirs):
        assert torch.isfinite(o).all() and o.abs().max() > 0
        _close(o, t, GRAD_REL_TOL)


# ---------------------------------------------------------------------------
# Finite differences and the backward passes each path reaches
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def port_smpl(body_models_dir):
    bm = port_on_cpu.port_model('smpl')
    fitters = weighted_fitters(smplfitter_tpu_torch, bm, 'smpl', np.random.default_rng(53),
                               smplfitter_tpu_torch.BodyFitter(bm))
    fitters['kid'] = smplfitter_tpu_torch.BodyFitter(bm, enable_kid=True)
    return bm, fitters


def _path_inputs(bm, batch, seed):
    rng = np.random.default_rng(seed)
    p = tuple(torch.as_tensor(x) for x in random_params(rng, batch))
    p += (torch.linspace(-0.5, 0.5, batch), fit_weights(torch, rng, batch, bm.num_vertices, 'cpu'),
          fit_weights(torch, rng, batch, bm.num_joints, 'cpu'))
    out = bm(*p[:3])
    return p, out['vertices'].detach(), out['joints'].detach()


FD_PATHS = ('headline', 'a_fit_no_joints', 'c_known_shape', 'e_scale_fit', 'f_call_weights')


@pytest.mark.parametrize('path', FD_PATHS)
def test_fit_grad_matches_fd(port_smpl, path):
    """tests/test_gradients.py's probe on the port: the headline as there
    (two iterations, no beta regularizer, the final adjustment, the targets'
    vertices differentiated with the joints fixed, loss betas^2 + trans^2,
    B=2), and four GRAD_PATHS paths with their result_loss in tv."""
    bm, fitters = port_smpl
    p, tv, tj = _path_inputs(bm, 2, seed=54)
    fitter = fitters['plain']
    if path == 'headline':
        def loss(tv_):
            res = fitter.fit(tv_, tj, num_iter=2, beta_regularizer=0.0, final_adjust_rots=True,
                             requested_keys=['shape_betas', 'trans'])
            return (res['shape_betas'] ** 2).sum() + (res['trans'] ** 2).sum()

        x = tv.clone().requires_grad_()
        g = torch.autograd.grad(loss(x), x)[0]
    else:
        vg = path_vg(torch, path, fitters, p)

        def loss(tv_):
            return vg(tv_, tj)[0]

        g = vg(tv, tj)[1][0]
    direction = torch.as_tensor(np.random.default_rng(102).normal(size=tv.shape),
                                dtype=torch.float32)
    direction /= direction.norm()
    eps = 1e-2  # large enough that f32 loss rounding does not dominate the quotient
    with torch.no_grad():
        fd = (loss(tv + eps * direction) - loss(tv - eps * direction)) / (2 * eps)
    np.testing.assert_allclose(float((g * direction).sum()), float(fd), rtol=0.12, atol=1e-3)


@pytest.mark.parametrize('name', list(GRAD_PATHS))
def test_gradient_path_reaches_its_backward_passes(port_smpl, name):
    """The CPU counterpart of chip_smoke.py phase 14's launch check: each
    wrapper call is one launch on the card, and each torch-op backward one
    TORCH_VJPS count; K14 and K15 run once per K6 and batched K5 call."""
    bm, fitters = port_smpl
    p, tv, tj = _path_inputs(bm, 4, seed=55)

    def key_of(wrapper, kwargs):
        return (bwd_key if wrapper in BWD_WRAPPERS else kernel_key)(wrapper, kwargs)

    port_k.reset_launch_counts()
    calls = record_calls(port_k, sorted(set(WRAPPERS) | set(BWD_WRAPPERS)),
                         lambda: path_vg(torch, name, fitters, p)(tv, tj), key_of)
    launches, vjps = grad_path_counts(name, 'smpl')
    assert {k: len(v) for k, v in calls.items() if v} == {k: n for k, n in launches.items() if n}
    assert {k: n for k, n in port_k.TORCH_VJPS.items() if n} == vjps
