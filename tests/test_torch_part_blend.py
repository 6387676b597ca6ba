"""The active-joint blends of K9 and K6 on the CPU.

K9 (``wgram_moments``) walks a static cover of the vertices, segments of at
most 32 vertices of one body part (``lbs_kernels.wgram_cover``), and K6
(``recon_part_sums_lm``) the segments of the part index
(``PartIndex.from_membership(..., weights=)``); both blend the per-joint
[R|t] entries over each segment's active joints only. These tests hold, on
the synthetic SMPL, SMPL-X, SMPL+H (``smplh16``) and MANO skinning weights
and on dense weights (every joint on every vertex):

- the cover holds every vertex below V exactly once, and each list holds
  exactly the joints with a nonzero weight on its segment's vertices;
- a blend over the lists, joint by joint in ascending order, equals the
  dense blend over every joint in the same order bit for bit (the terms left
  out are products with exact zeros);
- K9's twin against the JAX kernel in interpret mode at E = 20, above the
  old kernel's limit of 17 (scale modes 0 and 2), on a small synthetic model;
- K9's launch plan (columns per block, task split, splits, scratch) for
  E in {10, 16, 17, 32}.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch import BodyFitter
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import synthetic

from port_on_cpu import port_model

MODELS = {'smpl': 689, 'smplx': 1048, 'smplh16': 689, 'mano': 778}
REL_TOL = 2e-5  # as tests/test_torch_weights.py: the JAX kernel splits its dots into bf16 parts


def _weights(name):
    """(V, J) skinning weights: a synthetic model's, or dense ones at SMPL-X's J."""
    if name == 'dense':
        w = np.random.default_rng(5).uniform(0.01, 1.0, (300, 55))
        return w / w.sum(axis=1, keepdims=True)
    raw, _ = synthetic.make_raw_model(name, num_vertices=MODELS[name])
    return np.asarray(raw['weights'])


def _lists(segs, n_seg):
    off = segs.joint_offset.numpy()
    return [segs.joints.numpy()[off[s]:off[s + 1]] for s in range(n_seg)]


def _segment_verts(verts, seg_offset):
    off = seg_offset.numpy()
    return [verts.numpy()[off[s]:off[s + 1]] for s in range(len(off) - 1)]


def _part_index(w):
    """The part index of the dominant joints of ``w``, with its lists."""
    V, J = w.shape
    pm = np.zeros((J, -(-V // port_k.VC) * port_k.VC), np.float32)
    pm[np.argmax(w, axis=1), np.arange(V)] = 1
    return port_k.PartIndex.from_membership(pm, 'cpu', weights=w)


@pytest.mark.parametrize('name', list(MODELS) + ['dense'])
def test_cover_and_active_joint_lists(name):
    w = _weights(name)
    V = w.shape[0]
    cover = port_k.wgram_cover(w, V, 'cpu')
    segs = _segment_verts(cover.verts, cover.seg_offset)
    assert np.array_equal(np.sort(cover.verts.numpy()), np.arange(V)), 'each vertex once'
    assert cover.covers == V and cover.n_seg == len(segs)
    dominant = np.argmax(w, axis=1)
    for vs, js in zip(segs, _lists(cover, cover.n_seg)):
        assert 1 <= len(vs) <= 32 and len(set(dominant[vs])) == 1
        assert np.array_equal(js, np.nonzero(np.any(w[vs] != 0, axis=0))[0])
    assert cover.max_joints == max(len(js) for js in _lists(cover, cover.n_seg))
    parts = _part_index(w)
    psegs = _segment_verts(parts.verts, parts.seg_offset)
    assert np.array_equal(np.sort(parts.verts.numpy()), np.arange(V))
    for vs, js in zip(psegs, _lists(parts, parts.n_seg)):
        assert len(vs) <= 512
        assert np.array_equal(js, np.nonzero(np.any(w[vs] != 0, axis=0))[0])
    if name == 'dense':
        assert all(len(js) == 55 for js in _lists(cover, cover.n_seg))


def _blend_in_order(w, pj, vs, js):
    """sum_j w[v, j] pj[:, j] for the vertices vs over the joints js, joint by
    joint in the order given: (12, len(vs), B)."""
    out = torch.zeros((pj.shape[0], len(vs), pj.shape[2]), dtype=torch.float32)
    for j in js:
        out = out + w[vs, j][None, :, None] * pj[:, j][:, None, :]
    return out


@pytest.mark.parametrize('name', list(MODELS) + ['dense'])
def test_list_blend_equals_dense_blend(name):
    w = torch.as_tensor(_weights(name), dtype=torch.float32)
    V, J = w.shape
    pj = torch.as_tensor(np.random.default_rng(J).normal(size=(12, J, 3)), dtype=torch.float32)
    for segs in (port_k.wgram_cover(w.numpy(), V, 'cpu'), _part_index(w.numpy())):
        for vs, js in zip(_segment_verts(segs.verts, segs.seg_offset), _lists(segs, segs.n_seg)):
            vs = torch.as_tensor(vs, dtype=torch.long)
            assert torch.equal(_blend_in_order(w, pj, vs, js),
                               _blend_in_order(w, pj, vs, range(J)))


def test_fitter_carries_the_model_lists(tmp_path):
    """The fitter's part index and shape-solve data carry the lists of the
    model's own skinning weights."""
    synthetic.write_model_files(str(tmp_path), 'smpl', 432)
    bm = port_model('smpl', model_root=str(tmp_path / 'smpl'))
    fitter = BodyFitter(bm)
    w = bm.model_data.weights
    parts, cover = fitter.plan.parts, fitter.gram.wgram_cover
    pm = parts.pm.numpy()
    ref = port_k.PartIndex.from_membership(pm, 'cpu', weights=w)
    assert torch.equal(parts.joints, ref.joints)
    assert torch.equal(parts.joint_offset, ref.joint_offset)
    want = port_k.wgram_cover(w, bm.num_vertices, 'cpu')
    assert cover.covers == bm.num_vertices and cover.max_joints == want.max_joints
    for field in ('verts', 'seg_offset', 'joints', 'joint_offset'):
        assert torch.equal(getattr(cover, field), getattr(want, field)), field


def _wgram_operands(scale_mode, E=20, V=300, B=8):
    w = _weights('smpl')[:V]
    V, J = w.shape
    vp = -(-V // port_k.VC) * port_k.VC
    rng = np.random.default_rng(20 + scale_mode)

    def f32(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    w_pad = np.zeros((vp, J), np.float32)
    w_pad[:V] = w
    args = [f32(3, V, B), f32(12, J, B, scale=0.5), f32(3, vp, B, scale=0.3),
            f32(3 * E, J, B, scale=0.1), w_pad, f32(3, vp, E, scale=0.05),
            f32(3 * E, B, scale=0.1), rng.uniform(0.1, 2.0, (V, B)).astype(np.float32)]
    mu_s = f32(3, B, scale=0.1) if scale_mode else None
    return args, mu_s


@pytest.mark.parametrize('scale_mode', [0, 2])
def test_wgram_twin_matches_jax_above_e17(scale_mode):
    """K9's twin (through the wrapper, cover given) against the JAX kernel in
    interpret mode at E = 20; SA and r against the Cauchy-Schwarz bounds of
    their terms, as tests/test_torch_weights.py holds them."""
    args, mu_s = _wgram_operands(scale_mode)
    t = [torch.as_tensor(a) for a in args]
    cover = port_k.wgram_cover(args[4], args[7].shape[0], 'cpu')
    ours = port_k.wgram_moments(*t, mu_s=None if mu_s is None else torch.as_tensor(mu_s),
                                scale_mode=scale_mode, cover=cover)
    theirs = jax_k.wgram_moments(*args, mu_s=mu_s, scale_mode=scale_mode, interpret=True)
    G, SA, r, Sb, W = (o.numpy() for o in ours)
    E1 = r.shape[0]
    assert E1 == 20 + (1 if scale_mode else 0)
    tgt, pj, homog, _, w, _, _, om = t
    V = om.shape[0]
    pos = port_k._apply_blend(torch.einsum('vj,xjb->xvb', w[:V], pj), homog[:, :V])
    bb = (((tgt - pos) ** 2).sum(dim=0) * om).sum(dim=0).numpy()
    diag = G.reshape(E1, E1, -1)[np.arange(E1), np.arange(E1)]
    scales = dict(SA=np.sqrt(W * diag).max(), r=np.sqrt(diag * bb).max())
    for name, got, ref in zip(('G', 'SA', 'r', 'Sb', 'W'), (G, SA, r, Sb, W), theirs):
        ref = np.asarray(ref)
        assert got.shape == ref.shape, name
        scale = scales.get(name, np.max(np.abs(ref)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * scale, err_msg=name)


@pytest.mark.parametrize('scale_mode', [0, 1])
@pytest.mark.parametrize('E', [10, 16, 17, 32])
def test_wgram_launch_plan(E, scale_mode):
    """SMPL-X's J = 55 and its cover's 330 segments of 3 joints, and dense
    lists of 55: the Gram's padding and blocks, the task split, the columns
    per block and the splits."""
    J, n_seg, sms = 55, 330, 132
    E1 = E + scale_mode
    NP = -(-(E1 + 4) // 4) * 4
    for max_joints in (3, 55):
        plans = {B: port_k.wgram_plan(J, E, scale_mode, max_joints, n_seg, B, sms)
                 for B in (1, 1000, 4096)}
        for B, plan in plans.items():
            assert plan.padded == NP and plan.blocks == (NP // 4) * (NP // 4 + 1) // 2
            assert plan.part_floats == 16 * plan.blocks
            assert 96 % plan.row_groups == 0
            assert plan.row_groups * plan.blocks <= 32 * plan.tasks_per_lane
            use = plan.row_groups * plan.blocks / (32 * plan.tasks_per_lane)
            assert all(kg * plan.blocks / (32 * mt) <= use + 1e-9
                       for mt in (1, 2) for kg in (1, 2, 3, 4, 6, 8)
                       if kg * plan.blocks <= 32 * mt)
            fits = [c for c in (8, 4, 2) if port_k._wgram_smem(
                J, E, bool(scale_mode), c, max_joints, n_seg) <= 227 * 1024]
            assert plan.columns == fits[0] and plan.smem_bytes <= 227 * 1024
            grid_x = -(-B // plan.columns)
            assert plan.n_splits == max(1, min(n_seg, -(-2 * sms // grid_x)))
        if max_joints == 3 and E1 <= 16:  # SMPL and SMPL-X's per-call weighted solves
            assert plans[4096].columns == 8
        assert plans[4096].n_splits == 1 and plans[1].n_splits == 264
    with pytest.raises(ValueError):
        port_k.wgram_plan(J, 33, 0, 3, n_seg, 4096, sms)
