"""Vertex subsets of the port against the JAX package on the CPU.

- ``utils/decimation.decimate`` equals the JAX package's bit for bit (the
  farthest-point route: neither side has trimesh) at 96 and 1024 vertices of
  a synthetic SMPL at full size (V=6890), and the loaders write the same
  ``vertex_subset_{n}.npz`` for a missing subset;
- ``BodyModel(vertex_subset=...)`` against the JAX model on the same subset
  and against the full model's rows (1e-6), and the headline fit on the
  subset against JAX (bench.py's gate);
- every kernel twin (K1-K15) on operands captured from the port's forward
  pass, fits and backward passes on a subset of the synthetic SMPL (V=432)
  whose V = 300 puts a partial last tile in every kernel (300 % 256 = 44,
  300 % 32 = 12) and which leaves out every vertex of the left hand, so leaf
  part 22 has no vertex: against the JAX kernels in interpret mode (backward
  kernels: jax.vjp of their forward API) at B = 8, within 2e-5 x max|JAX|
  per output, the JAX kernels' bf16 split of each f32 dot (as in
  tests/test_torch_kernels.py). K2's cached form, K7, K8 and K12, which the
  small-F SMPL route does not run, are called on operands derived from the
  captured ones (``chip_smoke.large_f_forms``). K13's and K14's dtgt, whose
  terms cancel, are held to the scale of those terms (as in
  tests/test_torch_grad_paths.py).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import port_on_cpu
import smplfitter_tpu
import smplfitter_tpu_torch
from chip_smoke import (FIT_KW, SPECS, capture_forms, error_scales, random_params,
                        weighted_fitters)
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu.utils import decimation as jax_decimation
from smplfitter_tpu.utils import modeldata as jax_modeldata
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import decimation, modeldata, synthetic

SUBSET_V = 300
EMPTY_PART = 22  # the left hand, a leaf part
BATCH = 8
JAX_REL_TOL = 2e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope='module')
def full_size_smpl(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('smpl6890'))
    synthetic.write_model_files(root, 'smpl', 6890)
    return root + '/smpl'


@pytest.mark.parametrize('count', [96, 1024])
def test_decimate_matches_jax(full_size_smpl, count, tmp_path):
    data = modeldata.initialize('smpl', 'neutral', full_size_smpl)
    ours = decimation.decimate(data.v_template, data.faces, count)
    theirs = jax_decimation.decimate(data.v_template, data.faces, count)
    for o, t in zip(ours, theirs, strict=True):
        assert o.dtype == t.dtype
        np.testing.assert_array_equal(o, t)
    assert len(ours[0]) == count and len(np.unique(ours[0])) == count
    # The loaders decimate a missing subset into the same file.
    written = {}
    for name, loader in (('port', modeldata), ('jax', jax_modeldata)):
        root = tmp_path / name
        root.mkdir()
        for f in ('basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl', 'kid_template.npy'):
            (root / f).symlink_to(f'{full_size_smpl}/{f}')
        loader.initialize('smpl', 'neutral', str(root), vertex_subset_size=count)
        written[name] = np.load(root / f'vertex_subset_{count}.npz')
    for key in ('i_verts', 'faces'):
        np.testing.assert_array_equal(written['port'][key], written['jax'][key])
    np.testing.assert_array_equal(written['port']['i_verts'], ours[0])


@pytest.fixture(scope='module')
def subset_models(body_models_dir):
    """The JAX and the port's SMPL on a subset of V = 300 that empties leaf
    part 22, and the port's full model."""
    full = smplfitter_tpu.BodyModel('smpl', 'neutral')
    part = np.argmax(np.asarray(full.model_data.weights), axis=1)
    rng = np.random.default_rng(5)
    subset = np.sort(rng.choice(np.nonzero(part != EMPTY_PART)[0], SUBSET_V, replace=False))
    return (smplfitter_tpu.BodyModel('smpl', 'neutral', vertex_subset=subset),
            port_on_cpu.port_model('smpl', vertex_subset=subset),
            port_on_cpu.port_model_from(full), subset)


def test_subset_forward_matches_jax_and_full_rows(subset_models):
    jax_bm, bm, full, subset = subset_models
    assert bm.num_vertices == SUBSET_V and SUBSET_V % 256 <= 128 and SUBSET_V % 32
    np.testing.assert_array_equal(bm.vertex_subset, subset)
    assert not (np.argmax(bm.model_data.weights, axis=1) == EMPTY_PART).any()
    pose, betas, trans = random_params(np.random.default_rng(6), BATCH)
    ours = bm(pose, betas, trans)
    theirs = jax_bm(pose, betas, trans)
    rows = full(pose, betas, trans)
    for key in ('vertices', 'joints'):
        want = np.asarray(theirs[key])
        np.testing.assert_allclose(_np(ours[key]), want, atol=1e-6 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(_np(ours['vertices']), _np(rows['vertices'][:, subset]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(ours['joints']), _np(rows['joints']), atol=1e-6, rtol=0)


def test_subset_fit_matches_jax(subset_models):
    jax_bm, bm, full, subset = subset_models
    pose, betas, trans = random_params(np.random.default_rng(7), BATCH)
    out = full(pose, betas, trans)
    tv, tj = _np(out['vertices'][:, subset]), _np(out['joints'])
    theirs = smplfitter_tpu.BodyFitter(jax_bm).fit(tv, tj, **FIT_KW)
    ours = smplfitter_tpu_torch.BodyFitter(bm).fit(tv, tj, **FIT_KW)
    np.testing.assert_allclose(_np(ours['shape_betas']), np.asarray(theirs['shape_betas']),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(_np(ours['trans']), np.asarray(theirs['trans']), atol=1e-4,
                               rtol=0)
    # Every orientation, the emptied part's too (its rotation fit sees no vertex).
    np.testing.assert_allclose(_np(ours['orientations']), np.asarray(theirs['orientations']),
                               atol=1e-3, rtol=0)
    assert torch.isfinite(ours['pose_rotvecs']).all()


@pytest.fixture(scope='module')
def subset_calls(subset_models):
    """LAUNCHES key -> the first captured (args, kwargs) of every kernel form
    on the subset model at B = 8 (chip_smoke.capture_forms: the forward pass,
    the headline fit, paths a-l, the backward passes and the large-F forms)."""
    bm = subset_models[1]
    rng = np.random.default_rng(8)
    fitter = smplfitter_tpu_torch.BodyFitter(bm)
    fs = weighted_fitters(smplfitter_tpu_torch, bm, 'smpl', rng, fitter)
    fs['kid'] = smplfitter_tpu_torch.BodyFitter(bm, enable_kid=True)
    params = [torch.as_tensor(x) for x in random_params(rng, BATCH)]
    kid = torch.as_tensor(rng.normal(0, 0.5, BATCH).astype(np.float32))
    vw = torch.as_tensor(rng.uniform(0.1, 2.0, (BATCH, bm.num_vertices)).astype(np.float32))
    jw = torch.as_tensor(rng.uniform(0.1, 2.0, (BATCH, bm.num_joints)).astype(np.float32))
    forms = capture_forms(torch, port_k, bm, fs, params, kid, vw, jw)
    return {key: calls[0] for key, calls in forms.items()}


FWD = ('lbs_points', 'rhs_moments_h', 'rhs_moments', 'rhs_moments_scale', 'gram_assembly',
       'recon_part_sums_cached', 'part_sums', 'recon_part_sums', 'wgram',
       'rhs_moments_h_w', 'rhs_moments_w', 'rhs_moments_scale_w', 'recon_part_sums_cached_w',
       'part_sums_w', 'recon_part_sums_w',
       'posed_template', 'rhs_moments_cached', 'rhs_moments_cached_scale', 'term1')
BWD = ('lbs_points_bwd', 'rhs_moments_h_bwd', 'rhs_moments_bwd', 'rhs_moments_cached_bwd',
       'recon_part_sums_cached_bwd', 'recon_part_sums_bwd', 'part_sums_bwd',
       'rhs_moments_h_bwd_w', 'rhs_moments_bwd_w', 'recon_part_sums_cached_bwd_w',
       'recon_part_sums_bwd_w', 'part_sums_bwd_w')


def _call(calls, key):
    assert key in calls, f'{key} was not reached on the subset'
    return calls[key]


def _j(x):
    if isinstance(x, port_k.PartIndex):
        return _np(x.pm)
    return _np(x) if isinstance(x, torch.Tensor) else x


def _close(ours, theirs, scale=None, rows=None):
    ours, theirs = _np(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    if rows is not None:
        ours, theirs = ours[rows], theirs[rows]
    scale = np.abs(theirs).max() if scale is None else scale
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=JAX_REL_TOL * scale)


@pytest.mark.parametrize('key', FWD)
def test_subset_forward_twin_matches_jax(subset_calls, key):
    args, kw = _call(subset_calls, key)
    wrapper = SPECS[key][0]
    ours = port_k.twin_call(wrapper, args, kw)
    if key == 'term1':
        R, ksd = args
        E = int(round(ksd.shape[1] ** 0.5))
        # SMPL's whole Ksd fits one pass of the JAX kernel; stream it in 8-row
        # blocks as the JAX package does for SMPL-X.
        theirs = (jax_k._term1_blocked(_np(R), _np(ksd), E, R.shape[2], 8, True),)
    else:
        jkw = {k: _j(v) for k, v in kw.items() if k != 'cover'}
        theirs = getattr(jax_k, wrapper)(*map(_j, args), **jkw, interpret=True)
        theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    scales = error_scales(torch, port_k, key, args, ours)
    assert len(ours) == len(theirs)
    for o, t, scale in zip(ours, theirs, scales):
        if key != 'wgram':
            scale = None
        if o.dim() == 3 and o.shape[0] == 3 and o.shape[1] != np.shape(t)[1]:
            n = min(o.shape[1], np.shape(t)[1])  # per-vertex outputs: the first V rows
            o, t = o[:, :n], np.asarray(t)[:, :n]
        _close(o, t, scale)


def _term_scale(gst, graw, pm, pos):
    """max |gst_c| + sum_d |W[c*3+d] pos_d| over (c, v, b), W = pm^T graw: the
    terms that K13's and K14's dtgt sum, which cancel."""
    W = torch.einsum('jv,xjb->xvb', pm.double(), graw.double())
    terms = torch.einsum('jv,cjb->cvb', pm.double(), gst.double()).abs() + torch.stack(
        [sum((W[c * 3 + d] * pos[d].double()).abs() for d in range(3)) for c in range(3)])
    return terms.max().item()


@pytest.mark.parametrize('key', BWD)
def test_subset_backward_twin_matches_jax(subset_calls, key):
    args, kw = _call(subset_calls, key)
    wrapper = SPECS[key][0]
    ours = port_k.twin_call(wrapper, args, kw)
    om = None if kw.get('omega') is None else _np(kw['omega'])
    a = list(map(_j, args))
    rows = [None] * len(ours)
    scales = [None] * len(ours)
    if wrapper == 'lbs_points_bwd':
        g, pj, feat, w, consts = a
        _, vjp = jax.vjp(lambda p, f: jax_k.lbs_points(p, f, w, consts, interpret=True), pj,
                         feat)
        theirs = vjp(g)
        rows[1] = ~np.any(consts[3] != 0, axis=0)  # dfeat: not the homogeneous constant's row
    elif wrapper == 'rhs_moments_bwd':
        gr, gy, tgt, pj, feat, w, consts, sd = a
        fn = jax_k.rhs_moments_h if kw.get('gh') is not None else jax_k.rhs_moments
        _, vjp = jax.vjp(lambda t, p, f: fn(t, p, f, w, consts, sd, omega=om, interpret=True),
                         tgt, pj, feat)
        theirs = vjp((gr, gy) + ((_np(kw['gh']),) if kw.get('gh') is not None else ()))
        rows[2] = ~np.any(consts[3] != 0, axis=0)
    elif wrapper == 'rhs_moments_cached_bwd':
        gr, gy, tgt, pj, homog, w, sd = a
        _, vjp = jax.vjp(lambda t, p, h: jax_k.rhs_moments_cached(t, p, h, w, sd, omega=om,
                                                                  interpret=True),
                         tgt, pj, homog)
        theirs = vjp((gr, gy))
    elif wrapper == 'recon_part_sums_cached_bwd':
        graw, gst, gsa, tgt, pj, x, sd, homog, pm, w = a
        _, vjp = jax.vjp(lambda t, p, xx, h: jax_k.recon_part_sums_cached_lm(
            t, p, xx, sd, h, pm, w, omega=om, interpret=True), tgt, pj, x, homog)
        theirs = vjp((graw, gst, gsa))
        pos = port_k._apply_blend(torch.einsum('vj,xjb->xvb', args[9], args[4]),
                                  args[7] + torch.einsum('cve,eb->cvb', args[6], args[5]))
        scales[0] = _term_scale(args[1], args[0], args[8].pm, pos)
    elif wrapper == 'recon_part_sums_bwd':
        graw, gst, gsa, tgt, pj, feat, w, consts, pm = a
        _, vjp = jax.vjp(lambda t, p, f: jax_k.recon_part_sums_lm(
            t, p, f, w, consts, pm, omega=om, interpret=True), tgt, pj, feat)
        theirs = vjp((graw, gst, gsa))
        pos = port_k.lbs_points_ref(*args[4:8])
        scales[0] = _term_scale(args[1], args[0], args[8].pm, pos)
        rows[2] = ~np.any(consts[3] != 0, axis=0)
    else:
        graw, gst, gsa, t, r, pm = a
        _, vjp = jax.vjp(lambda tt, rr: jax_k.part_sums_vm_lm(tt, rr, pm, omega=om,
                                                               interpret=True), t, r)
        theirs = vjp((graw, gst, gsa))
    assert len(ours) == len(theirs)
    for o, t, scale, r in zip(ours, theirs, scales, rows):
        if o.dim() == 3 and o.shape[0] == 3 and o.shape[1] != np.shape(t)[1]:
            n = min(o.shape[1], np.shape(t)[1])
            o, t = o[:, :n], np.asarray(t)[:, :n]
        _close(o, t, scale, r)
