"""K14 and K15, the backward kernels of the fused reconstruction's part sums
(K6) and of the part sums (K5), as plain twins and autograd Functions, and
the gradients of the fitting paths they make differentiable, against the JAX
package on the CPU; and ``num_iter=0``.

Operands are captured from real backward passes of the port on the CPU
(``chip_smoke.backward_pass`` with the gradient paths of
``chip_smoke.CAPTURE_PATHS``: fits without joints, the flipper's warm start,
known shape, and ``scale_fit`` and known shape on static-weight fitters) on
the synthetic SMPL (V=432), SMPL-X (V=660, J=55, F=503 with the betas) and
MANO (V=778: 778 % 256 = 10, a last vertex chunk of 10 rows, the tail-row
case of the JAX backward kernels), at B=8 (the JAX kernels keep their full
vertex chunk at B <= 256).

- Each backward twin against jax.vjp of the JAX kernel API in interpret mode
  (``recon_part_sums_lm``, ``part_sums_vm_lm``), whose backward is the Pallas
  kernel: 2e-5 x max|JAX| per output, in every form (unweighted, static ω,
  K15's summed form for a batch-constant reference); K14's dtgt = gst +
  sum W pos cancels its terms, so it is held to 2e-5 x the scale of those
  terms (_dtgt_term_scale), as K9's cancelling outputs are on the card.
  dfeat is compared on every row but the homogeneous constant's, as K10's
  in tests/test_torch_grad_kernels.py.
- Each backward twin against torch.autograd of its forward twin: 1e-5.
- The Functions of K5 and K6 against autograd of their twins with every
  operand requiring grad; the constant operands get None.
- Fit gradients against ``jax.grad`` of the JAX fit with
  ``use_kernels=False`` (each JAX reference jitted once): value within 1e-4
  relative, gradients within 1e-3 x max|g_jax| (tests/test_torch_grad.py's
  limits): the flipper's call (kid, no joints, warm start, one iteration:
  K10, K15) and ``fit_with_known_shape`` with joints (three iterations and
  the final adjustment: K14) on SMPL and on SMPL-X.
- ``BodyFitter.fit(num_iter=0)`` fits as the JAX package's does (as
  ``num_iter=1``), at the headline fit's tolerance.
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
from chip_smoke import (FLIP_KW, NOISE_REL, NOISE_SEEDS, SPREAD_MULT, backward_pass, bwd_key,
                        random_params, record_calls, summed_calls, weighted_fitters)
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import synthetic

BATCH = 8
REL_TOL = 1e-5
JAX_REL_TOL = 2e-5
GRAD_REL_TOL = 1e-3
VALUE_RTOL = 1e-4
MANO_V = 778
FIT_ATOL = dict(shape_betas=1e-3, trans=1e-4, pose_rotvecs=1e-3)  # tests/test_torch_paths.py
BWD = ('part_sums_bwd', 'recon_part_sums_bwd')


@pytest.fixture(scope='module')
def captured(body_models_dir, tmp_path_factory):
    """model -> {LAUNCHES key: [(args, kwargs), ...]} of K14 and K15 in the
    gradients of the capture paths, with K15's summed forms derived from the
    batched ones (chip_smoke.summed_calls, as phase 13)."""
    mano_dir = str(tmp_path_factory.mktemp('mano778'))
    synthetic.write_model_files(mano_dir, 'mano', MANO_V)
    models = {'smpl': port_on_cpu.port_model('smpl'), 'smplx': port_on_cpu.port_model('smplx'),
              'mano': port_on_cpu.port_model('mano', model_root=mano_dir + '/mano')}
    out = {}
    for name, bm in models.items():
        rng = np.random.default_rng(30)
        fs = weighted_fitters(smplfitter_tpu_torch, bm, name, rng,
                              smplfitter_tpu_torch.BodyFitter(bm))
        if name != 'mano':
            fs['kid'] = smplfitter_tpu_torch.BodyFitter(bm, enable_kid=True)
        params = [torch.as_tensor(x) for x in random_params(rng, BATCH, name)]
        calls = record_calls(port_k, BWD, lambda: backward_pass(torch, bm, (), params, fs),
                             bwd_key)
        for key in ('part_sums_bwd', 'part_sums_bwd_w'):
            if calls[key]:
                calls[key.replace('bwd', 'bwd_sum')] = summed_calls(torch, calls[key])
        out[name] = calls
    return out


# form -> (model, LAUNCHES key)
FORMS = {
    'part_sums_smpl': ('smpl', 'part_sums_bwd'),
    'part_sums_smplx': ('smplx', 'part_sums_bwd'),
    'part_sums_mano': ('mano', 'part_sums_bwd'),
    'part_sums_w_smpl': ('smpl', 'part_sums_bwd_w'),
    'part_sums_w_smplx': ('smplx', 'part_sums_bwd_w'),
    'part_sums_sum_smpl': ('smpl', 'part_sums_bwd_sum'),
    'part_sums_sum_w_smpl': ('smpl', 'part_sums_bwd_sum_w'),
    'recon_smpl': ('smpl', 'recon_part_sums_bwd'),
    'recon_smplx': ('smplx', 'recon_part_sums_bwd'),
    'recon_mano': ('mano', 'recon_part_sums_bwd'),
    'recon_w_smpl': ('smpl', 'recon_part_sums_bwd_w'),
    'recon_w_smplx': ('smplx', 'recon_part_sums_bwd_w'),
}


def _pick(captured, form):
    model, key = FORMS[form]
    calls = captured[model][key]
    assert calls, f'{form}: {key} was not called by the backward passes'
    args, kw = calls[-1]
    return key.split('_bwd')[0] + '_bwd', args, kw


def _leaf(t):
    return t.detach().clone().requires_grad_()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rel, rows=None):
    ours, theirs = _np(ours), np.asarray(_np(theirs))
    assert ours.shape == theirs.shape
    if rows is not None:
        ours, theirs = ours[rows], theirs[rows]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * np.abs(theirs).max())


def _vjp_of_forward_twin(name, args, kw):
    om = kw.get('omega')
    if name == 'part_sums_bwd':
        graw, gst, gsa, t, a, parts = args
        xs = [_leaf(t), _leaf(a)]
        return torch.autograd.grad(port_k.part_sums_ref(*xs, parts.pm, omega=om), xs,
                                   (graw, gst, gsa))
    graw, gst, gsa, tgt, pj, feat, w, consts, parts = args
    xs = [_leaf(tgt), _leaf(pj), _leaf(feat)]
    outs = port_k.recon_part_sums_ref(*xs, w, consts, parts.pm, omega=om)
    return torch.autograd.grad(outs, xs, (graw, gst, gsa))


@pytest.mark.parametrize('form', list(FORMS))
def test_backward_twin_matches_autograd_of_forward_twin(captured, form):
    name, args, kw = _pick(captured, form)
    ours = port_k.twin_call(name, args, kw)
    theirs = _vjp_of_forward_twin(name, args, kw)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        _close(o, t, REL_TOL)


@pytest.mark.parametrize('form', list(FORMS))
def test_backward_twin_matches_jax_kernel(captured, form):
    name, args, kw = _pick(captured, form)
    om = None if kw.get('omega') is None else _np(kw['omega'])
    ours = port_k.twin_call(name, args, kw)
    if name == 'part_sums_bwd':
        graw, gst, gsa, t, a = map(_np, args[:5])
        pm = _np(args[5].pm)
        _, vjp = jax.vjp(lambda tt, aa: jax_k.part_sums_vm_lm(tt, aa, pm, omega=om,
                                                               interpret=True), t, a)
        theirs = vjp((graw, gst, gsa))
        for o, th in zip(ours, theirs):
            _close(o, th, JAX_REL_TOL)
        return
    graw, gst, gsa, tgt, pj, feat, w, consts = map(_np, args[:8])
    pm = _np(args[8].pm)
    _, vjp = jax.vjp(lambda t, p, f: jax_k.recon_part_sums_lm(t, p, f, w, consts, pm, omega=om,
                                                               interpret=True), tgt, pj, feat)
    dtgt, dpj, dfeat = vjp((graw, gst, gsa))
    np.testing.assert_allclose(_np(ours[0]), np.asarray(dtgt), rtol=0,
                               atol=JAX_REL_TOL * _dtgt_term_scale(args))
    _close(ours[1], dpj, JAX_REL_TOL)
    rows = ~np.any(consts[3] != 0, axis=0)  # all but the homogeneous constant's row
    assert rows.sum() == rows.size - 1
    _close(ours[2], dfeat, JAX_REL_TOL, rows)


def _dtgt_term_scale(args) -> float:
    """max over (c, v, b) of |gst_c| + sum_d |W[c*3+d] pos_d|, in f64: the
    scale of the terms K14's dtgt sums. They cancel: on the SMPL-X capture
    they are 126x max|dtgt|, so the JAX kernel's positions, 5.0e-6 off
    (their bf16 split), move its dtgt by 2.9e-4 x max|dtgt| but 2.3e-6 x
    this scale; the same formula on the JAX kernel's own positions gives its
    dtgt to 1.2e-6 x max|dtgt|."""
    graw, gst, _, _, pj, feat, w, consts, parts = (
        a.double() if isinstance(a, torch.Tensor) else a for a in args)
    pm = parts.pm.double()
    pos = port_k.lbs_points_ref(pj, feat, w, consts)
    W = torch.einsum('jv,xjb->xvb', pm, graw)
    terms = torch.einsum('jv,cjb->cvb', pm, gst).abs() + torch.stack(
        [sum((W[c * 3 + d] * pos[d]).abs() for d in range(3)) for c in range(3)])
    return terms.max().item()


FUNCTIONS = ('part_sums', 'part_sums_w', 'part_sums_sum', 'part_sums_sum_w', 'recon',
             'recon_w')


@pytest.mark.parametrize('form', FUNCTIONS)
def test_function_matches_autograd_of_twin(captured, form):
    """The Function under random cotangents on every output, with every
    operand requiring grad: t and a (K15), tgt, pj and feat (K14) get the
    twin's gradients, the skinning weights, templates and ω get None."""
    key = {'part_sums': 'part_sums_bwd', 'part_sums_w': 'part_sums_bwd_w',
           'part_sums_sum': 'part_sums_bwd_sum', 'part_sums_sum_w': 'part_sums_bwd_sum_w',
           'recon': 'recon_part_sums_bwd', 'recon_w': 'recon_part_sums_bwd_w'}[form]
    args, kw = captured['smpl'][key][0]
    om = kw.get('omega')
    if form.startswith('part_sums'):
        parts = args[5]
        operands, diff = (args[3], args[4], om), (0, 1)

        def fn(t, a, o):
            return port_k._PartSums.apply('part_sums', t, a, parts, o)

        def twin(t, a, o):
            return port_k.part_sums_ref(t, a, parts.pm, omega=o)
    else:
        parts = args[8]
        operands, diff = (*args[3:8], om), (0, 1, 2)

        def fn(t, p, f, w, c, o):
            return port_k._ReconLbs.apply('recon_part_sums', t, p, f, w, c, parts, o)

        def twin(t, p, f, w, c, o):
            return port_k.recon_part_sums_ref(t, p, f, w, c, parts.pm, omega=o)
    xs = [None if t is None else _leaf(t) for t in operands]
    outs = fn(*xs)
    gen = torch.Generator().manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    live = [x for x in xs if x is not None]
    got = torch.autograd.grad(outs, live, cots, allow_unused=True)
    ys = [None if t is None else _leaf(t) for t in operands]
    want = torch.autograd.grad(twin(*ys), [ys[i] for i in diff], cots)
    for i, g in enumerate(got):
        if i not in diff:
            assert g is None, f'{form}: constant operand {i} got a gradient'
    for g, t in zip([got[i] for i in diff], want):
        _close(g, t, REL_TOL)


# ---------------------------------------------------------------------------
# Fit gradients against the JAX package
# ---------------------------------------------------------------------------

GRAD_MODELS = ('smpl', 'smplx')
# path -> the loss's result keys
LOSS_KEYS = {'flipper': ('shape_betas', 'trans', 'pose_rotvecs', 'kid_factor'),
             'known_shape': ('trans', 'pose_rotvecs')}


@pytest.fixture(scope='module')
def grad_models(body_models_dir):
    out = {}
    for name in GRAD_MODELS:
        jax_bm = smplfitter_tpu.BodyModel(name, 'neutral')
        bm = port_on_cpu.port_model_from(jax_bm)
        out[name] = (jax_bm, bm)
    return out


def _inputs(jax_bm, name, seed):
    pose, betas, trans = random_params(np.random.default_rng(seed), BATCH, name)
    kid = np.linspace(-0.5, 0.5, BATCH).astype(np.float32)
    out = jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    return (pose, betas, trans, kid), np.asarray(out['vertices']), np.asarray(out['joints'])


def _call(path, fitter, p, tv, tj, **kw):
    """The path's call on either package's fitter."""
    if path == 'flipper':
        return fitter.fit(tv, initial_pose_rotvecs=p[0] + 0.05, initial_shape_betas=p[1] + 0.1,
                          initial_kid_factor=p[3] + 0.1, **FLIP_KW, **kw)
    return fitter.fit_with_known_shape(p[1], tv, tj, num_iter=3, final_adjust_rots=True, **kw)


@pytest.fixture(scope='module')
def jax_path_grads(grad_models):
    """(path, model) -> inputs, targets and the JAX package's value and
    gradient (in tv, and in tj where the path takes joints), each jitted and
    computed once on first use."""
    cache = {}

    def get(path, name):
        if (path, name) not in cache:
            jax_bm = grad_models[name][0]
            fitter = smplfitter_tpu.BodyFitter(jax_bm, enable_kid=path == 'flipper')
            p, tv, tj = _inputs(jax_bm, name, seed=40)

            def loss(tv_, tj_):
                res = _call(path, fitter, p, tv_, tj_, use_kernels=False)
                return sum(jnp.sum(res[k] ** 2) for k in LOSS_KEYS[path])

            argnums = (0,) if path == 'flipper' else (0, 1)
            value, grads = jax.jit(jax.value_and_grad(loss, argnums=argnums))(
                jnp.asarray(tv), jnp.asarray(tj))
            cache[path, name] = (p, tv, tj, float(value), [np.asarray(g) for g in grads])
        return cache[path, name]

    return get


def _port_value_grad(path, fitter, p, tv, tj):
    pt = [torch.as_tensor(x) for x in p]
    tv_t = torch.tensor(tv).requires_grad_()
    tj_t = torch.tensor(tj).requires_grad_()
    res = _call(path, fitter, pt, tv_t, tj_t)
    loss = sum((res[k] ** 2).sum() for k in LOSS_KEYS[path])
    leaves = (tv_t,) if path == 'flipper' else (tv_t, tj_t)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _own_spread(path, fitter, p, tv, tj, grads) -> float:
    """The gradient's largest change, relative to max|g|, over NOISE_SEEDS
    seeded changes of tv and tj by a factor 1 + NOISE_REL N(0, 1)
    (chip_smoke's spread rule)."""
    spread = 0.0
    for seed in range(NOISE_SEEDS):
        rng = np.random.default_rng(seed)
        tv_n, tj_n = ((t * (1 + NOISE_REL * rng.normal(size=t.shape))).astype(np.float32)
                      for t in (tv, tj))
        g_n = _port_value_grad(path, fitter, p, tv_n, tj_n)[1]
        spread = max(spread, max(((a - b).abs().max() / b.abs().max()).item()
                                 for a, b in zip(g_n, grads)))
    return spread


@pytest.mark.parametrize('path, name', [('flipper', 'smpl'), ('known_shape', 'smpl'),
                                        ('known_shape', 'smplx')])
def test_path_gradient_matches_jax(grad_models, jax_path_grads, path, name):
    """The flipper's call runs K10 and K15 (the warm start's K5 and the final
    adjustment's), known shape K14 four times. On SMPL-X the known-shape
    gradient moves by ~3e-3 x max|g| under 1e-7 relative target changes, in
    both packages (2.6e-3 to 3.2e-3 measured on either side at one and three
    iterations): its limit is the larger of 1e-3 and 4x its own spread, as
    the hand models' gradients are held on the card (chip_smoke.py phase 15)."""
    bm = grad_models[name][1]
    p, tv, tj, value, theirs = jax_path_grads(path, name)
    fitter = smplfitter_tpu_torch.BodyFitter(bm, enable_kid=path == 'flipper')
    loss, ours = _port_value_grad(path, fitter, p, tv, tj)
    np.testing.assert_allclose(loss.item(), value, rtol=VALUE_RTOL)
    limit = GRAD_REL_TOL
    if name != 'smpl':
        limit = max(limit, SPREAD_MULT * _own_spread(path, fitter, p, tv, tj, ours))
    for o, t in zip(ours, theirs):
        assert torch.isfinite(o).all() and o.abs().max() > 0
        _close(o, t, limit)


# ---------------------------------------------------------------------------
# num_iter=0
# ---------------------------------------------------------------------------


def test_num_iter_zero_fits_as_jax(grad_models):
    """``fit(num_iter=0)`` runs the final solve and the final adjustment
    (``range(num_iter - 1)`` rounds before them), as the JAX package's fit
    does, under tests/test_torch_paths.py's gate (betas and rotation vectors
    within 1e-3, translations within 1e-4). ``fit_with_known_shape(num_iter=0)`` runs no
    rotation fit before the final adjustment (``range(num_iter)``), as the
    JAX package's lane-major fit (its kernel path, in interpret mode here);
    its batch-major fit, which it runs on the CPU, fits once before
    ``range(num_iter - 1)``."""
    jax_bm, bm = grad_models['smpl']
    p, tv, tj = _inputs(jax_bm, 'smpl', seed=41)
    theirs = smplfitter_tpu.BodyFitter(jax_bm).fit(tv, tj, num_iter=0)
    fitter = smplfitter_tpu_torch.BodyFitter(bm)
    tv_t, tj_t = torch.tensor(tv), torch.tensor(tj)
    ours = fitter.fit(tv_t, tj_t, num_iter=0)
    one = fitter.fit(tv_t, tj_t, num_iter=1)
    for key, atol in FIT_ATOL.items():
        np.testing.assert_allclose(_np(ours[key]), np.asarray(theirs[key]), atol=atol, rtol=0,
                                   err_msg=key)
        torch.testing.assert_close(ours[key], one[key], rtol=0, atol=0)
    jax_k.FORCE_INTERPRET = True  # the JAX package's lane-major fit, which the port follows
    try:
        ks_theirs = smplfitter_tpu.BodyFitter(jax_bm).fit_with_known_shape(p[1], tv, tj,
                                                                            num_iter=0)
    finally:
        jax_k.FORCE_INTERPRET = False
    ks_ours = fitter.fit_with_known_shape(torch.as_tensor(p[1]), tv_t, tj_t, num_iter=0)
    for key in ('trans', 'pose_rotvecs'):
        np.testing.assert_allclose(_np(ks_ours[key]), np.asarray(ks_theirs[key]),
                                   atol=FIT_ATOL[key], rtol=0, err_msg=key)
