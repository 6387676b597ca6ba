"""The port's batch-major rotation and least-squares API, the refiners'
learning-rate schedule, and the Adam refiners ``BodyFitterOpt`` and
``BodyFlipperOpt`` against the JAX package on the CPU.

Inputs from a numpy seed; the synthetic SMPL of the suite (V=432), B = 4.
Limits:
- rotation functions: within 1e-6 (ROT_ATOL); ``proj_SO3``'s VJP within
  1e-5 x max|g| of ``jax.vjp`` (VJP_REL);
- ``lstsq``, ``normal_equations``, ``cholesky_solve`` and
  ``lstsq_partial_share`` (with and without ``batch_mask``): within 1e-5 x
  max|JAX| (LSTSQ_REL);
- the schedule at every step k of n in {1, 2, 7, 60}: within 4 f32 ulps of
  lr of optax's (f32 arithmetic there, float64 in the port);
- ``refine_steps=0``: the closed-form fit, equal;
- 10 Adam steps of ``BodyFitterOpt`` and ``BodyFlipperOpt``: every output
  within the larger of 1e-3 and 4x its own spread (its largest change over 3
  seeded 1e-7 relative changes of the targets or inputs, on the JAX package
  and on the port alike: Adam divides each gradient component by its own
  magnitude, so a component of pure rounding noise still moves by about lr a
  step), and the refined loss within 1e-4 relative (LOSS_REL);
- the JAX package's own properties of the refiners (``tests/test_apps.py``):
  refinement lowers the mean vertex error by 10%, and the refined flip is no
  worse than 1.02x the closed-form one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import smplfitter_tpu
import smplfitter_tpu_torch
from port_on_cpu import port_model_from
from smplfitter_tpu.ops import lstsq as jax_lstsq
from smplfitter_tpu.ops import rotation as jax_rot
from smplfitter_tpu_torch.models.bodyfitter_opt import refine_schedule
from smplfitter_tpu_torch.ops import lstsq as port_lstsq
from smplfitter_tpu_torch.ops import rotation as port_rot

ROT_ATOL = 1e-6
VJP_REL = 1e-5
LSTSQ_REL = 1e-5
SCHEDULE_ULPS = 4
LOSS_REL = 1e-4
PARAM_ATOL = 1e-3
NOISE_SEEDS = 3
NOISE_REL = 1e-7
SPREAD_MULT = 4
BATCH = 4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


# --- rotations ---------------------------------------------------------------


def _rotvecs(rng, n):
    """Rotation vectors of every angle: random, near zero and near pi."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = rng.uniform(0, np.pi, n)
    angles[:4] = [0.0, 1e-5, np.pi - 1e-3, np.pi - 1e-6]
    return (axes * angles[:, None]).astype(np.float32)


def _unit(rng, *shape):
    v = rng.normal(size=shape + (3,))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rotation_cases(rng):
    R = np.asarray(jax_rot.rotvec2mat(_rotvecs(rng, 64)))
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    X = rng.normal(size=(8, 20, 3)).astype(np.float32)
    Y = (X @ R[:8] + 0.01 * rng.normal(size=X.shape)).astype(np.float32)
    a, b = _unit(rng, 64), _unit(rng, 64)
    b[:2] = a[:2]  # parallel: the identity
    r6 = rng.normal(size=(5, 7, 6)).astype(np.float32)
    v, n = rng.normal(size=(64, 3)).astype(np.float32), _unit(rng, 64)
    return {
        'mat2rotvec': ((R,), jax_rot.mat2rotvec, port_rot.mat2rotvec),
        'proj_SO3': ((A,), jax_rot.proj_SO3, port_rot.proj_SO3),
        'kabsch': ((X, Y), jax_rot.kabsch, port_rot.kabsch),
        'align_unit_vectors': ((a, b), jax_rot.align_unit_vectors, port_rot.align_unit_vectors),
        'project_onto_plane': ((v, n), jax_rot.project_onto_plane, port_rot.project_onto_plane),
        'rot6d_to_rotmat': ((r6,), jax_rot.rot6d_to_rotmat, port_rot.rot6d_to_rotmat),
        'rotmat_to_rot6d': ((R,), jax_rot.rotmat_to_rot6d, port_rot.rotmat_to_rot6d),
    }


@pytest.mark.parametrize('name', ['mat2rotvec', 'proj_SO3', 'kabsch', 'align_unit_vectors',
                                  'project_onto_plane', 'rot6d_to_rotmat', 'rotmat_to_rot6d'])
def test_rotation_function_matches_jax(name):
    args, jax_fn, port_fn = _rotation_cases(np.random.default_rng(1))[name]
    want = np.asarray(jax_fn(*args))
    got = _np(port_fn(*[_t(a) for a in args]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ROT_ATOL, rtol=0)


def test_rot6d_round_trip():
    R = _np(port_rot.rotvec2mat(_t(_rotvecs(np.random.default_rng(2), 32))))
    back = _np(port_rot.rot6d_to_rotmat(port_rot.rotmat_to_rot6d(_t(R))))
    np.testing.assert_allclose(back, R, atol=ROT_ATOL, rtol=0)


def test_proj_SO3_vjp_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    G = rng.normal(size=(64, 3, 3)).astype(np.float32)
    _, vjp = jax.vjp(jax_rot.proj_SO3, jnp.asarray(A))
    want = np.asarray(vjp(jnp.asarray(G))[0])
    A_t = _t(A).requires_grad_()
    (got,) = torch.autograd.grad(port_rot.proj_SO3(A_t), A_t, _t(G))
    err = np.abs(_np(got) - want).max() / np.abs(want).max()
    assert err <= VJP_REL


# --- least squares -----------------------------------------------------------


def _system(seed, batch=5, rows=30, params=6, outs=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, rows, params)).astype(np.float32),
            rng.normal(size=(batch, rows, outs)).astype(np.float32),
            rng.uniform(0.1, 2.0, (batch, rows)).astype(np.float32),
            rng.uniform(0.1, 1.0, params).astype(np.float32),
            rng.normal(size=(batch, params, outs)).astype(np.float32))


def _close(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LSTSQ_REL * np.abs(want).max()


@pytest.mark.parametrize('ridge', [False, True])
def test_normal_equations_match_jax(ridge):
    A, b, w, l2, l2_rhs = _system(10)
    extra = (l2, l2_rhs) if ridge else ()
    for got, want in zip(port_lstsq.normal_equations(*[_t(x) for x in (A, b, w, *extra)]),
                         jax_lstsq.normal_equations(A, b, w, *extra)):
        _close(got, want)


@pytest.mark.parametrize('shared', [False, True])
def test_lstsq_matches_jax(shared):
    A, b, w, l2, l2_rhs = _system(11)
    _close(port_lstsq.lstsq(*[_t(x) for x in (A, b, w, l2, l2_rhs)], shared=shared),
           jax_lstsq.lstsq(A, b, w, l2, l2_rhs, shared=shared))


def test_cholesky_solve_matches_jax():
    A, b, w, l2, _ = _system(12)
    gram, moment = jax_lstsq.normal_equations(A, b, w, l2)
    chol = np.asarray(jnp.linalg.cholesky(gram))
    _close(port_lstsq.cholesky_solve(_t(chol), _t(moment)),
           jax_lstsq.cholesky_solve(chol, moment))


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('n_shared', [0, 2, 6])
def test_lstsq_partial_share_matches_jax(n_shared, masked):
    A, b, w, l2, l2_rhs = _system(13 + n_shared)
    mask = np.array([1, 1, 0, 1, 0], np.float32) if masked else None
    got = port_lstsq.lstsq_partial_share(*[_t(x) for x in (A, b, w, l2, l2_rhs)],
                                         n_shared=n_shared,
                                         batch_mask=None if mask is None else _t(mask))
    _close(got, jax_lstsq.lstsq_partial_share(A, b, w, l2, l2_rhs, n_shared=n_shared,
                                              batch_mask=mask))
    if n_shared:  # one shared solution on every row
        assert torch.equal(got[:, :n_shared], got[:1, :n_shared].expand(5, -1, -1))


# --- the schedule ------------------------------------------------------------


@pytest.mark.parametrize('lr, warmup_ratio', [(0.03, 0.5), (0.01, 0.25)])
@pytest.mark.parametrize('n', [1, 2, 7, 60])
def test_schedule_matches_optax(n, lr, warmup_ratio):
    warmup = max(1, int(n * warmup_ratio))
    want = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, warmup),
         optax.cosine_decay_schedule(lr, max(1, n - warmup))], [warmup])
    ours = refine_schedule(n, lr, warmup_ratio)
    ulp = float(np.spacing(np.float32(lr)))
    for k in range(n):
        # optax's Adam counts steps in int32 and evaluates the schedule
        # before the count increments: step k runs at schedule(k).
        theirs = float(np.asarray(want(jnp.asarray(k, jnp.int32))))
        assert abs(ours(k) - theirs) <= SCHEDULE_ULPS * ulp, (k, ours(k), theirs)
    assert ours(0) == 0.0


# --- the refiners ------------------------------------------------------------


@pytest.fixture(scope='module')
def smpl(body_models_dir):
    jax_bm = smplfitter_tpu.BodyModel('smpl', 'neutral')
    return jax_bm, port_model_from(jax_bm)


def _targets(jax_bm, seed, batch=BATCH):
    rng = np.random.default_rng(seed)
    pose = rng.normal(0, 0.1, (batch, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, 10)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    res = jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    return (pose, betas, trans), np.asarray(res['vertices']), np.asarray(res['joints'])


def _perturbed(arrays, seed):
    rng = np.random.default_rng(1000 + seed)
    return [(a * (1 + NOISE_REL * rng.normal(size=a.shape))).astype(np.float32)
            for a in arrays]


def _max_dparams(a, b):
    return {k: float(np.abs(_np(a[k]) - _np(b[k])).max()) for k in b}


def _refine_loss(bm, res, tv, tj=None, beta_regularizer=0.0):
    """The refiners' loss of a result, by the port's CPU model (rotation
    vectors through relative rotations)."""
    out = bm(_t(_np(res['pose_rotvecs'])), _t(_np(res['shape_betas'])), _t(_np(res['trans'])),
             None if 'kid_factor' not in res else _t(_np(res['kid_factor'])))
    loss = (out['vertices'] - _t(tv)).norm(dim=-1).mean()
    if tj is not None:
        loss = loss + (out['joints'] - _t(tj)).norm(dim=-1).mean()
    betas = _t(_np(res['shape_betas']))
    return float(loss + beta_regularizer * (betas[:, 2:] ** 2).mean())


def _hold_refined(ours, theirs, runs, inputs, loss_of):
    """The gate of the module docstring: every output within the larger of
    PARAM_ATOL and SPREAD_MULT x its own spread, the loss within LOSS_REL."""
    assert ours.keys() == theirs.keys()
    spread = {k: 0.0 for k in theirs}
    for run, base in zip(runs, (ours, theirs)):
        for seed in range(NOISE_SEEDS):
            for k, d in _max_dparams(run(*_perturbed(inputs, seed)), base).items():
                spread[k] = max(spread[k], d)
    gaps = _max_dparams(ours, theirs)
    for k, gap in gaps.items():
        assert gap <= max(PARAM_ATOL, SPREAD_MULT * spread[k]), (k, gap, spread[k])
        assert torch.isfinite(ours[k]).all()
    loss_ours, loss_theirs = loss_of(ours), loss_of(theirs)
    assert abs(loss_ours - loss_theirs) <= LOSS_REL * loss_theirs, (loss_ours, loss_theirs)


FIT_KW = dict(num_iter=2, beta_regularizer=0.0)


def test_refine_steps_zero_is_the_fit(smpl):
    _, bm = smpl
    _, tv, tj = _targets(smpl[0], 60)
    opt = smplfitter_tpu_torch.BodyFitterOpt(bm)
    got = opt.fit(tv, tj, refine_steps=0, **FIT_KW)
    want = opt.fitter.fit(tv, tj, requested_keys=('pose_rotvecs', 'shape_betas', 'trans'),
                          **FIT_KW)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_fitter_opt_matches_jax(smpl):
    jax_bm, bm = smpl
    _, tv, tj = _targets(jax_bm, 61)
    kw = dict(FIT_KW, refine_steps=10, refine_lr=0.01)
    ours_opt = smplfitter_tpu_torch.BodyFitterOpt(bm)
    theirs_opt = smplfitter_tpu.BodyFitterOpt(jax_bm)
    jitted = jax.jit(lambda v, j: theirs_opt.fit(v, j, **kw))

    def run_ours(v, j):
        return ours_opt.fit(v, j, **kw)

    ours, theirs = run_ours(tv, tj), jitted(tv, tj)
    assert set(ours) == {'pose_rotvecs', 'shape_betas', 'trans'}
    _hold_refined(ours, theirs, (run_ours, jitted), [tv, tj],
                  lambda r: _refine_loss(bm, r, tv, tj))


def test_flipper_opt_matches_jax(smpl):
    jax_bm, bm = smpl
    params, _, _ = _targets(jax_bm, 62)
    ours_opt = smplfitter_tpu_torch.BodyFlipperOpt(bm)
    theirs_opt = smplfitter_tpu.BodyFlipperOpt(jax_bm)
    np.testing.assert_array_equal(_np(ours_opt.flipper.mirror_inds),
                                  np.asarray(theirs_opt.flipper.mirror_inds))

    def runner(opt):
        return lambda *p: opt.flip(*p, num_iter=2, refine_steps=10, refine_lr=0.01)

    ours, theirs = runner(ours_opt)(*params), runner(theirs_opt)(*params)
    assert set(ours) == {'pose_rotvecs', 'shape_betas', 'trans', 'kid_factor'}
    target = ours_opt.flipper.flip_vertices(bm(*params)['vertices'])
    _hold_refined(ours, theirs, (runner(ours_opt), runner(theirs_opt)), list(params),
                  lambda r: _refine_loss(bm, r, target, beta_regularizer=1e-2))


def _v2v(bm, res, target):
    out = bm(res['pose_rotvecs'], res['shape_betas'], res['trans'])
    return float((out['vertices'] - _t(_np(target))).norm(dim=-1).mean())


def test_refinement_improves(smpl):
    """tests/test_apps.py's property, on the port: 60 Adam steps lower the
    mean vertex error of a 2-iteration fit by 10%."""
    _, bm = smpl
    _, tv, tj = _targets(smpl[0], 75)
    opt = smplfitter_tpu_torch.BodyFitterOpt(bm)
    base = opt.fit(tv, tj, refine_steps=0, **FIT_KW)
    refined = opt.fit(tv, tj, refine_steps=60, refine_lr=0.01, **FIT_KW)
    assert _v2v(bm, refined, tv) < _v2v(bm, base, tv) * 0.9


def test_flip_with_refinement(smpl):
    """tests/test_apps.py's property, on the port: 40 Adam steps leave the
    flip no worse than 1.02x the closed-form flip's mean vertex error."""
    _, bm = smpl
    params, _, _ = _targets(smpl[0], 77)
    flipper = smplfitter_tpu_torch.BodyFlipperOpt(bm)
    base = flipper.flip(*params, num_iter=2, refine_steps=0)
    refined = flipper.flip(*params, num_iter=2, refine_steps=40, refine_lr=0.01)
    target = flipper.flipper.flip_vertices(bm(*params)['vertices'])
    assert _v2v(bm, refined, target) <= _v2v(bm, base, target) * 1.02
    assert torch.isfinite(refined['pose_rotvecs']).all()
