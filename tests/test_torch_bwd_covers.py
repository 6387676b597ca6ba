"""The vertex lists that the backward kernels K10 (``lbs_points_bwd``) and K14
(``recon_part_sums_bwd``) walk.

K10 walks the cover that its forward K1 walked (``lbs_kernels.BlendSegments``,
passed on by ``_LbsPoints`` as ``cover=``), K14 the part index's segments cut
into tiles of at most 32 vertices (``PartIndex.tile_offset``, ``tile_seg``),
each tile with its segment's active joints. These tests hold, on the CPU:

- the part index's tiles on the fitters of the synthetic SMPL, SMPL-X, SMPL+H
  and MANO: consecutive, at most 32 vertices of one segment, every listed
  vertex once, ``unused`` exactly the vertices in no part;
- a torch model of the kernels' dpj order (a thread's 4 vertices in
  registers, the warp's tree over 8 vertex groups, the tiles of a run, the
  runs), summed over each tile's active joints only, equal bit for bit to
  the same order over every joint, on a cover and on a part index;
- ``lbs_points_bwd(cover=...)`` and ``recon_part_sums_bwd`` (unweighted and
  static ω) against jax.vjp of the JAX kernels ``lbs_points`` and
  ``recon_part_sums_lm`` in interpret mode, on SMPL (V = 432), SMPL-X
  (V = 660) and MANO (V = 240), B = 8;
- that ``_LbsPoints.backward`` passes the forward's cover on, and a forward
  pass's gradient the model's own;
- the checks the K10 wrapper makes of a cover, with ``_on_cuda`` patched to
  True (no launch): a cover short of the rows with nonzero weights, one
  past V_pad, and a call without a cover building one on the host (counted);
- ``lbs_kernels.dfeat_splits`` against one wave of the card.
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from chip_smoke import record_calls
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch import BodyFitter
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import synthetic

from port_on_cpu import port_model

MODELS = {'smpl': 432, 'smplx': 660, 'smplh16': 432, 'mano': 240}
BATCH = 8
# The wrappers (their twins on the CPU) against the JAX kernels in interpret
# mode, x max|JAX| per output.
JAX_REL_TOL = 1e-5


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """name -> (BodyModel, BodyFitter) of the synthetic models on the CPU."""
    d = tmp_path_factory.mktemp('bwd_covers')
    out = {}
    for name, V in MODELS.items():
        synthetic.write_model_files(str(d), name, V)
        bm = port_model(name, model_root=str(d / name))
        out[name] = (bm, BodyFitter(bm))
    return out


@pytest.mark.parametrize('name', list(MODELS))
def test_part_tiles(models, name):
    parts = models[name][1].plan.parts
    verts, off = parts.verts.numpy(), parts.seg_offset.numpy()
    toff, tseg = parts.tile_offset.numpy(), parts.tile_seg.numpy()
    assert toff[0] == 0 and toff[-1] == len(verts) and len(tseg) == parts.n_tiles
    sizes = np.diff(toff)
    assert np.all((sizes >= 1) & (sizes <= 32))
    for t in range(parts.n_tiles):
        s = tseg[t]
        assert off[s] <= toff[t] and toff[t + 1] <= off[s + 1]
        assert (toff[t] - off[s]) % 32 == 0
    assert np.array_equal(np.unique(tseg), np.arange(parts.n_seg))
    vpart = parts.vpart.numpy()
    assert np.array_equal(parts.unused.numpy(), np.nonzero(vpart < 0)[0])
    assert len(set(verts)) == len(verts) and np.all(vpart[verts] >= 0)
    assert len(verts) + len(parts.unused) == vpart.shape[0]


def _fma(a, b, c):
    """fmaf(a, b, c) of f32 tensors: one rounding (the exact product in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order_dpj(w, g, h, verts, tile_offset, lists, per_run):
    """dpj (12, J, B) of K10 and K14 in the kernels' order: per tile of at
    most 32 list rows and per joint of its list, a thread's 4 vertices
    (wg = w g_a rounded, then an FMA chain over the vertices for c < 3 and a
    sum for c = 3), the 8 vertex groups by the warp's tree (xor 16, 8, 4),
    the tiles of a run in order into the run's partial, then the runs in
    order. ``lists[t]`` gives the joints tile t adds to. Vectorized over the
    rows a, the vertex groups and the batch."""
    J, B = w.shape[1], g.shape[2]
    n_tiles = len(tile_offset) - 1
    wz = torch.cat([w, torch.zeros((1, J))])  # row -1: no vertex
    gz = torch.cat([g, torch.zeros((3, 1, B))], dim=1)
    hz = torch.cat([h, torch.zeros((3, 1, B))], dim=1)
    dpj = torch.zeros((12, J, B))
    for r0 in range(0, n_tiles, per_run):
        part = torch.zeros((12, J, B))
        for t in range(r0, min(r0 + per_run, n_tiles)):
            rows = verts[tile_offset[t]:tile_offset[t + 1]]
            rows = torch.tensor(rows + [-1] * (32 - len(rows)))
            gt, ht = gz[:, rows].view(3, 8, 4, B), hz[:, rows].view(3, 8, 4, B)
            for j in lists[t]:
                wg = wz[rows, j].view(1, 8, 4, 1) * gt  # (a, tm, i, b)
                s = torch.empty((3, 4, 8, B))
                for c in range(3):
                    acc = torch.zeros((3, 8, B))
                    for i in range(4):
                        acc = _fma(wg[:, :, i], ht[c, :, i].unsqueeze(0), acc)
                    s[:, c] = acc
                s[:, 3] = ((wg[:, :, 0] + wg[:, :, 1]) + wg[:, :, 2]) + wg[:, :, 3]
                groups = list(s.reshape(12, 8, B).unbind(1))
                for stride in (4, 2, 1):  # the tree of reduce_scatter8
                    groups = [groups[i] + groups[i + stride] if (i // stride) % 2 == 0
                              else groups[i - stride] + groups[i] for i in range(8)]
                part[:, j] += groups[0]
        dpj += part
    return dpj


@pytest.mark.parametrize('walk', ['cover', 'parts'])
def test_dpj_over_active_joints_equals_dense_sum(walk):
    raw, _ = synthetic.make_raw_model('smpl', num_vertices=150)
    w = torch.as_tensor(np.asarray(raw['weights']), dtype=torch.float32)
    V, J = w.shape
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.normal(size=(3, V, 3)), dtype=torch.float32)
    h = torch.as_tensor(rng.normal(size=(3, V, 3)), dtype=torch.float32)
    if walk == 'cover':
        lists_of = port_k.wgram_cover(w.numpy(), V, 'cpu')
        tile_offset, seg_of = lists_of.seg_offset.tolist(), list(range(lists_of.n_seg))
    else:
        pm = np.zeros((J, V), np.float32)
        pm[np.argmax(w.numpy(), axis=1), np.arange(V)] = 1
        pm[:, ::7] = 0  # vertices in no part
        lists_of = port_k.PartIndex.from_membership(pm, 'cpu', weights=w.numpy())
        tile_offset, seg_of = lists_of.tile_offset.tolist(), lists_of.tile_seg.tolist()
    off, joints = lists_of.joint_offset.tolist(), lists_of.joints.tolist()
    active = [joints[off[s]:off[s + 1]] for s in seg_of]
    every = [list(range(J))] * len(seg_of)
    verts = lists_of.verts.tolist()
    assert sum(map(len, active)) < sum(map(len, every))
    for per_run in (1, 4):
        got = _kernel_order_dpj(w, g, h, verts, tile_offset, active, per_run)
        assert torch.equal(got, _kernel_order_dpj(w, g, h, verts, tile_offset, every, per_run))
    listed = torch.zeros(V)
    listed[verts] = 1.0
    hh = torch.cat([h, torch.ones((1, V, 3))])
    want = torch.einsum('vj,v,avb,cvb->acjb', w, listed, g, hh).reshape(12, J, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def forward_calls(models):
    """name -> the (args, kwargs) of the model's K1 call in a forward pass at B = 8."""
    out = {}
    for name, (bm, _) in models.items():
        if name == 'smplh16':
            continue
        rng = np.random.default_rng(len(name))
        pose = rng.normal(0, 0.2, (BATCH, 3 * bm.num_joints)).astype(np.float32)
        betas = rng.normal(0, 1, (BATCH, bm.num_betas)).astype(np.float32)
        calls = record_calls(port_k, ('lbs_points',), lambda: bm(pose, betas))
        out[name] = calls['lbs_points'][0]
    return out


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rows=None):
    ours, theirs = _np(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    if rows is not None:
        ours, theirs = ours[rows], theirs[rows]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=JAX_REL_TOL * np.abs(theirs).max())


def _feat_rows(consts):
    """dfeat's rows but the homogeneous constant's: the JAX VJP also contracts
    consts[3], the channel the forward takes as the constant 1 (as in
    tests/test_torch_grad_kernels.py)."""
    return ~np.any(_np(consts)[3] != 0, axis=0)


@pytest.mark.parametrize('name', ['smpl', 'smplx', 'mano'])
def test_lbs_points_bwd_with_cover_matches_jax(models, forward_calls, name):
    (pj, feat, w, consts), kw = forward_calls[name]
    assert kw['cover'] is models[name][0].lbs_cover
    g = torch.as_tensor(np.random.default_rng(1).normal(size=(3, w.shape[0], BATCH)),
                        dtype=torch.float32)
    got = port_k.lbs_points_bwd(g, pj, feat, w, consts, cover=kw['cover'])
    _, vjp = jax.vjp(lambda p, f: jax_k.lbs_points(p, f, _np(w), _np(consts), interpret=True),
                     _np(pj), _np(feat))
    dpj, dfeat = vjp(_np(g))
    _close(got[0], dpj)
    _close(got[1], dfeat, _feat_rows(consts))


@pytest.mark.parametrize('name, omega', [('smpl', False), ('smplx', False), ('mano', False),
                                         ('smpl', True)])
def test_recon_part_sums_bwd_matches_jax(models, forward_calls, name, omega):
    (pj, feat, w, consts), _ = forward_calls[name]
    parts = models[name][1].plan.parts
    rng = np.random.default_rng(2)
    V, Vp, J = models[name][0].num_vertices, w.shape[0], w.shape[1]
    t = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    graw, gst, gsa, tgt = t(9, J, BATCH), t(3, J, BATCH), t(3, J, BATCH), t(3, V, BATCH)
    om = None
    if omega:
        om = torch.as_tensor(rng.uniform(0.1, 2.0, (Vp, 1)), dtype=torch.float32)
        om[V:] = 0.0
    got = port_k.recon_part_sums_bwd(graw, gst, gsa, tgt, pj, feat, w, consts, parts, omega=om)
    pm = _np(parts.pm)
    _, vjp = jax.vjp(lambda tt, p, f: jax_k.recon_part_sums_lm(
        tt, p, f, _np(w), _np(consts), pm, omega=None if om is None else _np(om), interpret=True),
        _np(tgt), _np(pj), _np(feat))
    dtgt, dpj, dfeat = vjp((_np(graw), _np(gst), _np(gsa)))
    _close(got[0], dtgt)
    _close(got[1], dpj)
    _close(got[2], dfeat, _feat_rows(consts))


def test_backward_passes_the_forward_cover(models, forward_calls, monkeypatch):
    """_LbsPoints.backward hands K10 the cover that K1 walked: a call's own,
    and the model's in a forward pass's gradient."""
    seen = []
    original = port_k.lbs_points_bwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get('cover'))
        return original(*args, **kwargs)

    monkeypatch.setattr(port_k, 'lbs_points_bwd', spy)
    (pj, feat, w, consts), kw = forward_calls['smpl']
    other = port_k.wgram_cover(w.numpy(), w.shape[0], 'cpu')
    p = pj.detach().requires_grad_()
    port_k.lbs_points(p, feat, w, consts, cover=other).sum().backward()
    bm = models['smpl'][0]
    pose = torch.zeros((2, 3 * bm.num_joints), requires_grad=True)
    bm(pose, torch.zeros((2, bm.num_betas)))['vertices'].sum().backward()
    assert seen[0] is other and seen[1] is bm.lbs_cover and len(seen) == 2
    assert pose.grad is not None and p.grad is not None


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers take CPU tensors for card ones; any launch fails."""
    def no_launch():
        raise AssertionError('a kernel launch was attempted')

    monkeypatch.setattr(port_k, '_on_cuda', lambda name, **tensors: True)
    monkeypatch.setattr(port_k._build, 'library', no_launch)


def test_cover_checks_on_the_card(models, forward_calls, on_card):
    (pj, feat, w, consts), _ = forward_calls['smpl']
    V = models['smpl'][0].num_vertices
    g = torch.zeros((3, w.shape[0], BATCH))
    short = port_k.wgram_cover(w.numpy(), V - 5, 'cpu')
    with pytest.raises(ValueError, match='nonzero rows'):
        port_k.lbs_points_bwd(g, pj, feat, w, consts, cover=short)
    past = port_k.wgram_cover(np.concatenate([w.numpy(), w.numpy()[:1]]), w.shape[0] + 1, 'cpu')
    with pytest.raises(ValueError, match='the cover holds'):
        port_k.lbs_points_bwd(g, pj, feat, w, consts, cover=past)
    assert all(n == 0 for n in port_k.LAUNCHES.values())


def test_missing_cover_is_built_and_counted(forward_calls, on_card, monkeypatch):
    built = {}

    def spy(weights, num_vertices, device):
        built['rows'] = num_vertices
        raise RuntimeError('built')

    monkeypatch.setattr(port_k, 'wgram_cover', spy)
    port_k.reset_launch_counts()
    (pj, feat, w, consts), _ = forward_calls['smpl']
    with pytest.raises(RuntimeError, match='built'):
        port_k.lbs_points_bwd(torch.zeros((3, w.shape[0], BATCH)), pj, feat, w, consts)
    assert port_k.HOST_COVERS['lbs_points_bwd'] == 1 and built['rows'] == w.shape[0]


@pytest.mark.parametrize('F, B, Vp, want', [
    (503, 4096, 10496, 2),  # SMPL-X: 4 x 16 tiles, two splits fill 128 SMs
    (219, 4096, 6912, 4),   # SMPL: 2 x 16 tiles
    (503, 1000, 10496, 8),  # 4 x 4 tiles
    (146, 1, 1024, 66),     # one batch column: 2 tiles
    (146, 4096, 5, 1),      # one k stage of 15 rows: no split
])
def test_dfeat_splits_fill_one_wave(monkeypatch, F, B, Vp, want):
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: types.SimpleNamespace(multi_processor_count=132))
    assert port_k.dfeat_splits(F, B, Vp, 'cuda') == want
