"""The port's kernel twins against the JAX package's Pallas kernels.

The operands are the ones the port's main path gives each kernel: they are
captured from a forward pass and a fit of the synthetic SMPL model (V=432,
padded to 512) on the CPU, where every wrapper runs its plain twin. The same
operands go through the JAX kernel API in interpret mode, as
tests/test_pallas_kernels.py runs it. Per-vertex outputs are compared on the
first V rows. Tolerance: 2e-5 x max|JAX output| per output; the JAX kernels
split each f32 dot into bf16 parts (about 2^-16 relative per product), the
twins are plain f32.

The hand-written CUDA kernels themselves are checked against the same twins
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import port_on_cpu
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch.ops import lbs_kernels as port_k

REL_TOL = 2e-5


@pytest.fixture(scope='module')
def port_model(body_models_dir):
    from smplfitter_tpu_torch import BodyFitter

    bm = port_on_cpu.port_model('smpl', 'neutral')
    return bm, BodyFitter(bm)


def _captured_calls(port_model, batch: int) -> dict:
    """The four wrappers' arguments from one forward pass and one fit."""
    bm, fitter = port_model
    rng = np.random.default_rng(batch)
    pose = rng.normal(0, 0.3, (batch, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, 10)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    names = ('lbs_points', 'rhs_moments_h', 'gram_assembly', 'recon_part_sums_cached_lm')
    calls = {name: [] for name in names}
    originals = {name: getattr(port_k, name) for name in names}

    def recorder(name):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return wrapped

    try:
        for name in names:
            setattr(port_k, name, recorder(name))
        out = bm(pose, betas, trans)
        fitter.fit(out['vertices'], out['joints'], num_iter=3, beta_regularizer=1.0,
                   final_adjust_rots=True, requested_keys=('pose_rotvecs',))
    finally:
        for name in names:
            setattr(port_k, name, originals[name])
    return calls


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _jax_call(name, args, kwargs):
    if name == 'lbs_points':
        return (jax_k.lbs_points(*map(_np, args), interpret=True),)
    if name == 'rhs_moments_h':
        return jax_k.rhs_moments_h(*map(_np, args), interpret=True)
    if name == 'gram_assembly':
        return jax_k.gram_assembly(*map(_np, args), has_joints=kwargs['has_joints'],
                                   interpret=True)
    tgt, pj, x, sd, homog, parts, weights = args
    return jax_k.recon_part_sums_cached_lm(
        _np(tgt), _np(pj), _np(x), _np(sd), _np(homog), _np(parts.pm), _np(weights),
        interpret=True)


def _twin_call(name, args, kwargs):
    if name == 'lbs_points':
        return (port_k.lbs_points_ref(*args),)
    if name == 'rhs_moments_h':
        return port_k.rhs_moments_h_ref(*args)
    if name == 'gram_assembly':
        return port_k.gram_assembly_ref(*args, **kwargs)
    tgt, pj, x, sd, homog, parts, weights = args
    return port_k.recon_part_sums_cached_ref(tgt, pj, x, sd, homog, parts.pm, weights)


@pytest.mark.parametrize('batch', [8, 16])
@pytest.mark.parametrize(
    'name', ['lbs_points', 'rhs_moments_h', 'gram_assembly', 'recon_part_sums_cached_lm'])
def test_twin_matches_jax_kernel(port_model, name, batch):
    bm = port_model[0]
    calls = _captured_calls(port_model, batch)[name]
    assert calls, f'{name} was not called on the main path'
    args, kwargs = calls[0]  # the first call: largest residuals of the fit
    twin = _twin_call(name, args, kwargs)
    ref = _jax_call(name, args, kwargs)
    assert len(twin) == len(ref)
    for t, r in zip(twin, ref):
        t, r = t.numpy(), np.asarray(r)
        if r.shape[1] >= bm.num_vertices:  # per-vertex output (3, V_pad, B)
            t, r = t[:, :bm.num_vertices], r[:, :bm.num_vertices]
        assert t.shape == r.shape
        scale = np.max(np.abs(r))
        np.testing.assert_allclose(t, r, rtol=0, atol=REL_TOL * scale)


def test_wrappers_dispatch_cpu_tensors_to_twins(port_model):
    """On CPU tensors each wrapper returns its twin's result and launches nothing."""
    port_k.reset_launch_counts()
    calls = _captured_calls(port_model, 8)
    assert all(v == 0 for v in port_k.LAUNCHES.values())
    for name, arg_sets in calls.items():
        args, kwargs = arg_sets[0]
        got = getattr(port_k, name)(*args, **kwargs)
        got = got if isinstance(got, tuple) else (got,)
        for g, t in zip(got, _twin_call(name, args, kwargs)):
            assert torch.equal(g, t)
            assert g.is_contiguous()


@pytest.mark.parametrize('problem', ['dtype', 'contiguity', 'shape', 'device'])
def test_wrapper_rejects_bad_operands(port_model, problem):
    args, _ = _captured_calls(port_model, 8)['lbs_points'][0]
    pj, feat, weights, consts = args
    if problem == 'dtype':
        pj = pj.double()
    elif problem == 'contiguity':
        feat = feat.T.contiguous().T
    elif problem == 'shape':
        weights = weights[:-1]
    else:
        consts = consts.to('meta')
    with pytest.raises((TypeError, ValueError)):
        port_k.lbs_points(pj, feat, weights, consts)


def test_part_index_matches_membership():
    rng = np.random.default_rng(0)
    J, V = 3, 3000  # parts of ~800 vertices: several segments each
    pm = np.zeros((J, V), np.float32)
    used = rng.random(V) < 0.8
    pm[rng.integers(0, J, V)[used], np.nonzero(used)[0]] = 1.0
    parts = port_k.PartIndex.from_membership(pm, 'cpu')
    verts = parts.verts.numpy()
    seg = parts.seg_offset.numpy()
    rebuilt = np.zeros_like(pm)
    for j in range(J):
        s0, s1 = parts.part_seg[j].item(), parts.part_seg[j + 1].item()
        for s in range(s0, s1):
            assert 0 < seg[s + 1] - seg[s] <= 512
            rebuilt[j, verts[seg[s]:seg[s + 1]]] = 1.0
    np.testing.assert_array_equal(rebuilt, pm)
    assert parts.n_seg > J
    with pytest.raises(ValueError):
        port_k.PartIndex.from_membership(pm + pm, 'cpu')
