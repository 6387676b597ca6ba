"""The port's backward kernels (K10-K13) as plain twins, its autograd
Functions, and the closed-form VJPs of the SO(3) projection and the SPD
solve, against the JAX package on the CPU.

Operands are captured from real backward passes of the port on the CPU: the
gradient of a forward pass and of the headline fit of synthetic SMPL (V=432,
padded to 512), unweighted, with static fit weights (the ω forms of K11 and
K13) and through the known-pose fits (K11's plain form and its ω form); and
of SMPL-X (V=660,
padded to 768, J=55, F=487), unweighted and with static weights: K10 at
F=503, K12 and its ω form, K13 at J=55.

- Each backward twin against torch.autograd of its forward twin, on the same
  operands and cotangents: 1e-5 x max|autograd| (plain f32 on both sides,
  other summation orders).
- Each backward twin against jax.vjp of the JAX kernel API in interpret mode,
  whose backward is the Pallas backward kernel: 2e-5 x max|JAX| per output
  (the JAX kernels split each f32 dot into bf16 parts, as in
  tests/test_torch_kernels.py); K13's dtgt 5e-5 (JAX_DTGT_RECON_TOL). dfeat
  is compared on every row but the homogeneous constant's: the JAX VJP also
  contracts consts[3], the channel that the forward takes as the constant 1,
  into a cotangent of the pinned constant feature that the fit discards; the
  port leaves it out, as the JAX package's own cached form does
  (tests/test_pallas_kernels.py).
- Each autograd Function against autograd of its forward twin under random
  cotangents on every output, with every operand requiring grad: the
  cotangents reach the right operands (the emitted template's too), ω is
  applied, and the constant operands get None.
- proj_SO3_lm and solve_spd_unrolled against the JAX custom VJPs, also at
  nearly degenerate spectra.
- A kernel form called on the card (``_on_cuda`` patched to True) with an
  operand that its backward treats as a constant requiring grad raises
  NotImplementedError before anything is launched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_on_cpu
from chip_smoke import backward_pass, record_calls
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu.ops import lstsq as jax_lstsq
from smplfitter_tpu.ops import rotation as jax_rot
from smplfitter_tpu_torch import BodyFitter
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.ops import lstsq as port_lstsq
from smplfitter_tpu_torch.ops import rotation as port_rot

REL_TOL = 1e-5
JAX_REL_TOL = 2e-5
# K13's dtgt = gst + sum_d W pos_d against JAX: the JAX kernel's positions
# carry its bf16 split's ~1.4e-5 relative error and the sum cancels terms up
# to about twice its size (2.5e-5 measured at SMPL-X).
JAX_DTGT_RECON_TOL = 5e-5
# The damped 3x3 solve of the SO(3) VJP at a reflection with coalescing
# singular values: its determinant is ~1e-6 of its entries, so f32 rounding in
# another operation order moves the result by ~1e-7 / 1e-6 relative.
REFLECTION_TOL = 1e-3
BATCH = 8
BWD = ('lbs_points_bwd', 'rhs_moments_bwd', 'rhs_moments_cached_bwd',
       'recon_part_sums_cached_bwd')
FWD = ('gram_assembly', 'term1', 'posed_template_lm')
# model -> (joints, betas, pose std)
SHAPES = {'smpl': (24, 10, 0.3), 'smplx': (55, 16, 0.1)}


def _params(model, seed):
    J, S, pose_std = SHAPES[model]
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(x.astype(np.float32)) for x in (
        rng.normal(0, pose_std, (BATCH, 3 * J)), rng.normal(0, 1, (BATCH, S)),
        rng.normal(0, 0.5, (BATCH, 3)))]


def _capture(bm, fitters, seed):
    """The arguments of the backward wrappers (and of the forward wrappers
    whose backward is PyTorch ops) in the gradients of a forward pass and of
    each fitter's headline and known-pose fits (``chip_smoke.backward_pass``,
    which phase 13 on the card captures from too)."""
    params = _params(bm.model_name, seed)
    return record_calls(port_k, BWD + FWD, lambda: backward_pass(torch, bm, fitters, params))


@pytest.fixture(scope='module')
def captured(body_models_dir):
    out = {}
    for model in SHAPES:
        bm = port_on_cpu.port_model(model, 'neutral')
        rng = np.random.default_rng(1)
        static = BodyFitter(bm, vertex_weights=rng.uniform(0.1, 2.0, bm.num_vertices),
                            joint_weights=rng.uniform(0.1, 2.0, bm.num_joints))
        out[model] = _capture(bm, (BodyFitter(bm), static), seed=2)
    return out


# form -> (model, wrapper, predicate on the call's keyword arguments)
FORMS = {
    'lbs_points': ('smpl', 'lbs_points_bwd', lambda kw: True),
    'lbs_points_smplx': ('smplx', 'lbs_points_bwd', lambda kw: True),
    'rhs_h': ('smpl', 'rhs_moments_bwd',
              lambda kw: kw['gh'] is not None and kw['omega'] is None),
    'rhs_h_w': ('smpl', 'rhs_moments_bwd',
                lambda kw: kw['gh'] is not None and kw['omega'] is not None),
    'rhs_plain': ('smpl', 'rhs_moments_bwd', lambda kw: kw['gh'] is None and kw['omega'] is None),
    'rhs_plain_w': ('smpl', 'rhs_moments_bwd',
                    lambda kw: kw['gh'] is None and kw['omega'] is not None),
    'rhs_cached': ('smplx', 'rhs_moments_cached_bwd', lambda kw: kw['omega'] is None),
    'rhs_cached_w': ('smplx', 'rhs_moments_cached_bwd', lambda kw: kw['omega'] is not None),
    'recon': ('smpl', 'recon_part_sums_cached_bwd', lambda kw: kw['omega'] is None),
    'recon_w': ('smpl', 'recon_part_sums_cached_bwd', lambda kw: kw['omega'] is not None),
    'recon_smplx': ('smplx', 'recon_part_sums_cached_bwd', lambda kw: kw['omega'] is None),
}


def _pick(captured, form):
    model, name, pred = FORMS[form]
    calls = [c for c in captured[model][name] if pred(c[1])]
    assert calls, f'{form}: {name} was not called by the backward passes'
    return name, calls[0]


def _leaf(t):
    return t.detach().clone().requires_grad_()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x


def _close(ours, theirs, rel, rows=None):
    ours, theirs = _np(ours), np.asarray(_np(theirs))
    assert ours.shape == theirs.shape
    if rows is not None:
        ours, theirs = ours[rows], theirs[rows]
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * scale)


def _vjp_of_forward_twin(name, args, kw):
    """torch.autograd's VJP of the forward twin for a captured backward call."""
    om = kw.get('omega')
    if name == 'lbs_points_bwd':
        g, pj, feat, w, consts = args
        xs = [_leaf(pj), _leaf(feat)]
        return torch.autograd.grad(port_k.lbs_points_ref(*xs, w, consts), xs, g)
    if name == 'rhs_moments_bwd':
        gr, gy, tgt, pj, feat, w, consts, sd = args
        xs = [_leaf(tgt), _leaf(pj), _leaf(feat)]
        if kw['gh'] is None:
            return torch.autograd.grad(port_k.rhs_moments_ref(*xs, w, consts, sd, omega=om), xs,
                                       (gr, gy))
        outs = port_k.rhs_moments_h_ref(*xs, w, consts, sd, omega=om)
        return torch.autograd.grad(outs, xs, (gr, gy, kw['gh']))
    if name == 'rhs_moments_cached_bwd':
        gr, gy, tgt, pj, homog, w, sd = args
        xs = [_leaf(tgt), _leaf(pj), _leaf(homog)]
        return torch.autograd.grad(port_k.rhs_moments_cached_ref(*xs, w, sd, omega=om), xs,
                                   (gr, gy))
    graw, gst, gsa, tgt, pj, x, sd, homog, parts, w = args
    xs = [_leaf(tgt), _leaf(pj), _leaf(x), _leaf(homog)]
    outs = port_k.recon_part_sums_cached_ref(xs[0], xs[1], xs[2], sd, xs[3], parts.pm, w,
                                             omega=om)
    return torch.autograd.grad(outs, xs, (graw, gst, gsa))


@pytest.mark.parametrize('form', list(FORMS))
def test_backward_twin_matches_autograd_of_forward_twin(captured, form):
    name, (args, kw) = _pick(captured, form)
    ours = port_k.twin_call(name, args, kw)
    theirs = _vjp_of_forward_twin(name, args, kw)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        _close(o, t, REL_TOL)


def _jax_vjp(name, args, kw):
    """jax.vjp of the JAX kernel API (interpret mode) for a captured call;
    and the rows of dfeat to compare (None: all)."""
    om = None if kw.get('omega') is None else _np(kw['omega'])
    if name == 'lbs_points_bwd':
        g, pj, feat, w, consts = map(_np, args)
        _, vjp = jax.vjp(lambda p, f: jax_k.lbs_points(p, f, w, consts, interpret=True), pj, feat)
        return vjp(g), None, consts
    if name == 'rhs_moments_bwd':
        gr, gy, tgt, pj, feat, w, consts, sd = map(_np, args)
        if kw['gh'] is None:
            fn = lambda t, p, f: jax_k.rhs_moments(t, p, f, w, consts, sd, omega=om,  # noqa: E731
                                                   interpret=True)
            cots = (gr, gy)
        else:
            fn = lambda t, p, f: jax_k.rhs_moments_h(t, p, f, w, consts, sd,  # noqa: E731
                                                     omega=om, interpret=True)
            cots = (gr, gy, _np(kw['gh']))
        _, vjp = jax.vjp(fn, tgt, pj, feat)
        return vjp(cots), 2, consts
    if name == 'rhs_moments_cached_bwd':
        gr, gy, tgt, pj, homog, w, sd = map(_np, args)
        _, vjp = jax.vjp(lambda t, p, h: jax_k.rhs_moments_cached(t, p, h, w, sd, omega=om,
                                                                  interpret=True), tgt, pj, homog)
        return vjp((gr, gy)), None, None
    graw, gst, gsa, tgt, pj, x, sd, homog, parts, w = args
    sd, w, pm = _np(sd), _np(w), _np(parts.pm)
    _, vjp = jax.vjp(lambda t, p, xx, h: jax_k.recon_part_sums_cached_lm(
        t, p, xx, sd, h, pm, w, omega=om, interpret=True), *map(_np, (tgt, pj, x, homog)))
    return vjp(tuple(map(_np, (graw, gst, gsa)))), None, None


@pytest.mark.parametrize('form', list(FORMS))
def test_backward_twin_matches_jax_kernel(captured, form):
    name, (args, kw) = _pick(captured, form)
    ours = port_k.twin_call(name, args, kw)
    theirs, _, consts = _jax_vjp(name, args, kw)
    assert len(ours) == len(theirs)
    feat_index = {'lbs_points_bwd': 1, 'rhs_moments_bwd': 2}.get(name)
    for i, (o, t) in enumerate(zip(ours, theirs)):
        rows = None
        if i == feat_index:  # dfeat: all rows but the homogeneous constant's
            rows = ~np.any(consts[3] != 0, axis=0)
            assert rows.sum() == rows.size - 1
        recon_dtgt = name == 'recon_part_sums_cached_bwd' and i == 0
        _close(o, t, JAX_DTGT_RECON_TOL if recon_dtgt else JAX_REL_TOL, rows)


def _functions(captured):
    """form -> (call of the autograd Function, call of the forward twin,
    operands, indices of the differentiable ones)."""
    def first(model, name, pred=lambda kw: True):
        return next(c for c in captured[model][name] if pred(c[1]))

    out = {}
    g, pj, feat, w, consts = first('smpl', 'lbs_points_bwd')[0]
    out['lbs_points'] = (port_k._LbsPoints.apply, port_k.lbs_points_ref,
                         (pj, feat, w, consts), (0, 1))
    for form, model, pred in (('rhs_h', 'smpl', lambda kw: kw['omega'] is None),
                              ('rhs_h_w', 'smpl', lambda kw: kw['omega'] is not None)):
        args, kw = first(model, 'rhs_moments_bwd',
                         lambda kw, p=pred: kw['gh'] is not None and p(kw))
        _, _, tgt, pj, feat, w, consts, sd = args
        om = kw['omega']
        out[form] = (
            lambda *a, om=om: port_k._RhsMoments.apply('rhs_moments_h', *a, None, True, False, om),
            lambda *a, om=om: port_k.rhs_moments_h_ref(*a, omega=om),
            (tgt, pj, feat, w, consts, sd), (0, 1, 2))
    args, kw = first('smpl', 'rhs_moments_bwd', lambda kw: kw['gh'] is None and kw['omega'] is None)
    _, _, tgt, pj, feat, w, consts, sd = args
    out['rhs_plain'] = (
        lambda *a: port_k._RhsMoments.apply('rhs_moments', *a, None, False, False, None),
        port_k.rhs_moments_ref, (tgt, pj, feat, w, consts, sd), (0, 1, 2))
    for form, pred in (('rhs_cached', lambda kw: kw['omega'] is None),
                       ('rhs_cached_w', lambda kw: kw['omega'] is not None)):
        args, kw = first('smplx', 'rhs_moments_cached_bwd', pred)
        _, _, tgt, pj, homog, w, sd = args
        om = kw['omega']
        out[form] = (
            lambda t, p, h, ww, s, om=om: port_k._RhsMoments.apply(
                'rhs_moments_cached', t, p, None, ww, None, s, h, False, False, om),
            lambda *a, om=om: port_k.rhs_moments_cached_ref(*a, omega=om),
            (tgt, pj, homog, w, sd), (0, 1, 2))
    for form, pred in (('recon', lambda kw: kw['omega'] is None),
                       ('recon_w', lambda kw: kw['omega'] is not None)):
        args, kw = first('smpl', 'recon_part_sums_cached_bwd', pred)
        _, _, _, tgt, pj, x, sd, homog, parts, w = args
        om = kw['omega']
        out[form] = (
            lambda t, p, xx, s, h, ww, om=om, parts=parts: port_k._ReconCached.apply(
                'recon_part_sums_cached', t, p, xx, s, h, parts, ww, om),
            lambda t, p, xx, s, h, ww, om=om, parts=parts: port_k.recon_part_sums_cached_ref(
                t, p, xx, s, h, parts.pm, ww, omega=om),
            (tgt, pj, x, sd, homog, w), (0, 1, 2, 4))
    args, kw = captured['smpl']['gram_assembly'][0]
    n_diff = 5 if kw['has_joints'] else 3
    out['gram_assembly'] = (
        lambda *a, hj=kw['has_joints']: port_k._GramAssembly.apply(*a, hj),
        lambda *a, hj=kw['has_joints']: port_k.gram_assembly_ref(*a, has_joints=hj),
        args, tuple(range(n_diff)))
    out['term1'] = (port_k._Term1.apply, port_k.term1_ref, captured['smplx']['term1'][0][0],
                    (0,))
    out['posed_template'] = (port_k._PosedTemplate.apply, port_k.posed_template_ref,
                             captured['smplx']['posed_template_lm'][0][0], (0,))
    return out


FUNCTIONS = ('lbs_points', 'rhs_h', 'rhs_h_w', 'rhs_plain', 'rhs_cached', 'rhs_cached_w',
             'recon', 'recon_w', 'gram_assembly', 'term1', 'posed_template')


@pytest.mark.parametrize('form', FUNCTIONS)
def test_function_matches_autograd_of_twin(captured, form):
    fn, twin, operands, diff = _functions(captured)[form]
    xs = [_leaf(t) for t in operands]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    got = torch.autograd.grad(outs, xs, cots, allow_unused=True)
    ys = [_leaf(t) for t in operands]
    want = torch.autograd.grad(twin(*ys), [ys[i] for i in diff], cots)
    for i, g in enumerate(got):
        if i not in diff:
            assert g is None, f'{form}: constant operand {i} got a gradient'
    for g, t in zip([got[i] for i in diff], want):
        _close(g, t, REL_TOL)


def test_wrapper_on_cpu_runs_the_twin_when_a_constant_requires_grad(captured):
    """On the CPU a constant operand that requires grad gets its gradient
    from the twin (as before the Functions)."""
    g, pj, feat, w, consts = next(iter(captured['smpl']['lbs_points_bwd']))[0]
    w1, w2 = _leaf(w), _leaf(w)
    got = torch.autograd.grad(port_k.lbs_points(pj, feat, w1, consts).sum(), w1)[0]
    want = torch.autograd.grad(port_k.lbs_points_ref(pj, feat, w2, consts).sum(), w2)[0]
    torch.testing.assert_close(got, want)


# ---------------------------------------------------------------------------
# The closed-form VJPs of the SO(3) projection and the SPD solve
# ---------------------------------------------------------------------------


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    axis=1).reshape(n, 3, 3)


def _so3_input(kind, n=64):
    """(9, n) matrices A = R diag(s): generic (s random); two singular values
    within 1e-5 of each other (the projection is smooth there, autograd of
    the eigensolver is not); or the same with the smallest one's sign flipped,
    a reflection whose two smallest singular values coalesce: the projection
    is not differentiable there and the VJP's damping keeps it finite."""
    rng = np.random.default_rng({'generic': 4, 'near_degenerate': 5, 'reflection': 6}[kind])
    if kind == 'generic':
        A = rng.normal(size=(n, 3, 3))
    else:
        s = np.ones((n, 3)) + 1e-5 * rng.normal(size=(n, 3))
        s[:, 0] += 0.5
        if kind == 'reflection':
            s[:, 2] *= -1
        A = _rotations(rng, n) * s[:, None, :]
    return A.reshape(n, 9).T.astype(np.float32)


@pytest.mark.parametrize('kind', ['generic', 'near_degenerate', 'reflection'])
def test_proj_so3_vjp_matches_jax(kind):
    """The port's VJP against the JAX package's closed form on the same
    (A, R, G); the projections themselves agree where they are smooth (at the
    reflection the rotation moves by O(1) under f32 rounding of A)."""
    A = _so3_input(kind)
    G = np.random.default_rng(7).normal(size=A.shape).astype(np.float32)
    x = torch.as_tensor(A).requires_grad_()
    R = port_rot.proj_SO3_lm(x)
    (got,) = torch.autograd.grad(R, x, torch.as_tensor(G))
    assert torch.isfinite(got).all()
    want = jax_rot._proj_SO3_bwd_entries(list(jnp.asarray(A)), list(jnp.asarray(R.detach())),
                                         list(jnp.asarray(G)))
    _close(got, np.stack(want), REL_TOL if kind != 'reflection' else REFLECTION_TOL)
    if kind != 'reflection':
        R_j, vjp = jax.vjp(jax_rot.proj_SO3_lm, jnp.asarray(A))
        _close(R.detach(), R_j, REL_TOL)
        _close(got, vjp(jnp.asarray(G))[0], REL_TOL)


@pytest.mark.parametrize('rhs_cols', [0, 2])
def test_solve_spd_vjp_matches_jax(rhs_cols):
    """A batch of SPD systems of the fit's size (n = 13: ten betas and the
    translation) with a vector or a two-column right-hand side; G's cotangent
    lives on its lower triangle in both packages."""
    rng = np.random.default_rng(8)
    n, B = 13, 16
    M = rng.normal(size=(B, n, n))
    G = (M @ M.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    rhs_shape = (B, n) if rhs_cols == 0 else (B, n, rhs_cols)
    rhs = rng.normal(size=rhs_shape).astype(np.float32)
    gx = rng.normal(size=rhs_shape).astype(np.float32)
    x_j, vjp = jax.vjp(jax_lstsq.solve_spd_unrolled, jnp.asarray(G), jnp.asarray(rhs))
    want = vjp(jnp.asarray(gx))
    xs = [torch.as_tensor(G).requires_grad_(), torch.as_tensor(rhs).requires_grad_()]
    x = port_lstsq.solve_spd_unrolled(*xs)
    got = torch.autograd.grad(x, xs, torch.as_tensor(gx))
    _close(x.detach(), x_j, REL_TOL)
    for g, t in zip(got, want):
        _close(g, t, REL_TOL)


def test_solve_spd_vjp_matches_autograd_of_the_solve():
    """The closed form against autograd through the unrolled factorization,
    on the symmetric part that both represent."""
    rng = np.random.default_rng(9)
    n, B = 13, 4
    M = rng.normal(size=(B, n, n))
    G = torch.as_tensor(M @ M.transpose(0, 2, 1) + n * np.eye(n), dtype=torch.float32)
    rhs = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32)
    g1, g2 = _leaf(G), _leaf(G)
    got = torch.autograd.grad(port_lstsq.solve_spd_unrolled(g1, rhs).sum(), g1)[0]
    want = torch.autograd.grad(port_lstsq._solve_spd_impl(g2, rhs, 1e-30).sum(), g2)[0]
    _close(torch.tril(got), torch.tril(want), REL_TOL)


# ---------------------------------------------------------------------------
# A constant operand that requires grad is refused on the card
# ---------------------------------------------------------------------------


def _small_operands():
    """Tiny operands of every kernel form (V_pad 256, V_t 200, J 4, B 3, E 2,
    F 5); the part index on the CPU."""
    rng = np.random.default_rng(10)
    Vp, Vt, J, B, E, F = 256, 200, 4, 3, 2, 5

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    pm = np.zeros((J, Vp), np.float32)
    pm[rng.integers(0, J, Vt), np.arange(Vt)] = 1.0
    return dict(tgt=t(3, Vt, B), pj=t(12, J, B), feat=t(F, B), w=t(Vp, J), consts=t(4, Vp, F),
                sd=t(3, Vp, E), homog=t(3, Vp, B), x=t(E, B), a=t(3, Vt, B), om_call=t(Vt, B),
                om_static=t(Vp, 1), t4=t(3 * E, J, B), mu=t(3 * E, B),
                parts=port_k.PartIndex.from_membership(pm, 'cpu'))


# Every kernel form has a backward on the card (K10-K15, or torch ops); an
# operand that the backward treats as a constant gets none there.
GUARDED = {
    'lbs_points_constant': lambda o: port_k.lbs_points(o['pj'], o['feat'], _leaf(o['w']),
                                                       o['consts']),
    'rhs_moments_h_omega_grad': lambda o: port_k.rhs_moments_h(
        _leaf(o['tgt']), o['pj'], o['feat'], o['w'], o['consts'], o['sd'],
        omega=_leaf(o['om_static'])),
    'part_sums_static_omega_grad': lambda o: port_k.part_sums_vm_lm(
        _leaf(o['tgt']), o['a'], o['parts'], omega=_leaf(o['om_static'])),
    'recon_part_sums_constant': lambda o: port_k.recon_part_sums_lm(
        o['tgt'], _leaf(o['pj']), o['feat'], o['w'], _leaf(o['consts']), o['parts']),
    'wgram_constant': lambda o: port_k.wgram_moments(
        _leaf(o['tgt']), o['pj'], o['homog'], o['t4'], o['w'], _leaf(o['sd']), o['mu'],
        o['om_call']),
}


@pytest.mark.parametrize('form', list(GUARDED))
def test_form_without_backward_refuses_gradient_on_the_card(monkeypatch, form):
    def no_launch():
        raise AssertionError('a kernel launch was attempted')

    monkeypatch.setattr(port_k, '_on_cuda', lambda name, **tensors: True)
    monkeypatch.setattr(port_k._build, 'library', no_launch)
    before = dict(port_k.LAUNCHES)
    with pytest.raises(NotImplementedError, match='treats as a constant'):
        GUARDED[form](_small_operands())
    assert port_k.LAUNCHES == before
