"""K4 (``recon_part_sums_cached_lm``) and K13 (``recon_part_sums_cached_bwd``)
on the part index's segments, on the CPU.

K4 walks each segment of the part index (``lbs_kernels.PartIndex``) in tiles
of 32 listed vertices and blends over the segment's active joints; K13 walks
the index's 32-vertex tiles with K14's front, writes dh and sums dx. These
tests hold:

- (a) torch models of the kernels' summation orders, over each segment's
  active joints, equal bit for bit to the same orders over every joint: K4's
  (4 vertices per thread, the 8 vertex groups in order, the tiles of a
  segment, the segments of a part in order) and K13's dh, dpj and dx (the
  tiles of a run, the warp's tree over its 8 vertex groups, the runs in
  order), on a synthetic SMPL of V = 150 with some vertices in no part;
- (b) the wrappers (their twins on the CPU) against the JAX package's
  kernels in interpret mode: K4 unweighted, static ω and per-call ω, K13
  unweighted and static ω against ``jax.vjp`` of the JAX K4, on operands of
  the port's own fits of SMPL (V = 432), SMPL-X with the kid column (E = 17)
  and MANO (V = 778: 0 < V % 256 <= 128), B = 8, within 2e-5 x max|JAX|
  (JAX_REL_TOL) and 1e-6 of the twin's formula in float64;
- (c) the wrappers' checks with ``_on_cuda`` patched to True and a stand-in
  library (nothing launches): E > 32 refused by both, J = 55 taken by K13,
  and the run plan K13 passes (``_segment_runs`` over the index's tiles);
- that a model loaded with ``vertex_subset_size`` and no subset file
  decimates the template, writes ``vertex_subset_{n}.npz`` and loads it.
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
from smplfitter_tpu_torch.utils import modeldata, synthetic
from test_torch_bwd_covers import _fma, _kernel_order_dpj

from port_on_cpu import port_model

BATCH = 8
# The wrappers against the JAX kernels in interpret mode, x max|JAX| per
# output: the JAX kernels split each f32 dot into bf16 parts (as in
# tests/test_torch_grad_kernels.py), which leaves SMPL-X's dx and dh about
# 1e-5 of their largest entries from a float64 evaluation of the formula.
JAX_REL_TOL = 2e-5
# The wrappers against their twin's formula evaluated in float64.
F64_REL_TOL = 1e-6
# (V, betas, kid column): E = 10, 17 (SMPL-X's 16 betas and the kid column), 10.
MODELS = {'smpl': (432, 10, False), 'smplx': (660, 16, True), 'mano': (778, 10, False)}


# ---------------------------------------------------------------------------
# (a) The kernels' summation orders over the active joints
# ---------------------------------------------------------------------------


def _tree8(x):
    """The warp's reduce-scatter (tmpl::reduce_scatter8) over axis 0 of size 8:
    pairs of groups tm, tm ^ 4, then ^ 2, then ^ 1."""
    return ((x[0] + x[4]) + (x[2] + x[6])) + ((x[1] + x[5]) + (x[3] + x[7]))


def _blend_pos(w, pj, h, rows, joints):
    """tmpl::blend_pos at the list rows (3, n, B): per joint in list order,
    t = pj . [h, 1] as an FMA chain, pos = fma(w_vj, t, pos)."""
    pos = torch.zeros_like(h)
    for j in joints:
        wv, p = w[rows, j].view(1, -1, 1), pj[:, j].unsqueeze(1)
        t = torch.stack([_fma(p[a * 4], h[0], _fma(p[a * 4 + 1], h[1],
                                                    _fma(p[a * 4 + 2], h[2], p[a * 4 + 3])))
                         for a in range(3)])
        pos = _fma(wv, t, pos)
    return pos


def _blend_project(w, pj, f, rows, joints):
    """tmpl::blend_project: g_c = sum_j w_vj sum_a pj[a*4+c, j] f_a in list
    order, the inner sum as fma(p0, f0, fma(p1, f1, p2 f2))."""
    g = torch.zeros_like(f)
    for j in joints:
        wv, p = w[rows, j].view(1, -1, 1), pj[:, j].unsqueeze(1)
        s = torch.stack([_fma(p[c], f[0], _fma(p[4 + c], f[1], p[8 + c] * f[2]))
                         for c in range(3)])
        g = _fma(wv, s, g)
    return g


def _hfull(homog, sd, x, rows):
    """homog + SD x at the list rows (tmpl::add_shape_dot: an FMA per shape
    column, in column order)."""
    h = homog[:, rows]
    for e in range(x.shape[0]):
        h = _fma(sd[:, rows, e].unsqueeze(2), x[e], h)
    return h


def _tiles(verts, beg, end):
    """The list rows of a span in tiles of 32, -1 past its end (32 n,)."""
    rows = list(verts[beg:end])
    rows += [-1] * (-len(rows) % 32)
    return torch.tensor(rows)


def _padded(x):
    """x (C, V, B) with a zero row appended: row -1 reads zeros."""
    return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)


def _k4_kernel_order(parts, lists, w, pj, homog, sd, x, tgt):
    """raw (9, J, B), s_t, s_a (3, J, B) in K4's order, unweighted: per
    segment and vertex group tm, the thread's sums over its 4 rows of each
    tile, tile after tile (raw by FMA, s_t and s_a by adds); the segment's
    partial sums the 8 groups in order; each part sums its segments in
    order. ``lists[s]``: the joints segment s blends."""
    J, B = w.shape[1], x.shape[1]
    wz = torch.cat([w, torch.zeros((1, J))])
    hz, tz, sdz = _padded(homog), _padded(tgt), _padded(sd)
    off, verts = parts.seg_offset.tolist(), parts.verts.tolist()
    partials = []
    for s in range(parts.n_seg):
        rows = _tiles(verts, off[s], off[s + 1])
        pos = _blend_pos(wz, pj, _hfull(hz, sdz, x, rows), rows, lists[s])
        t = tz[:, rows]
        acc = torch.zeros((15, 8, B))
        for tile in range(len(rows) // 32):
            for i in range(4):
                at = slice(32 * tile + i, 32 * tile + 32, 4)  # row 4 tm + i of each group
                tc, pc = t[:, at], pos[:, at]
                for c in range(3):
                    for d in range(3):
                        acc[3 * c + d] = _fma(tc[c], pc[d], acc[3 * c + d])
                    acc[9 + c] = acc[9 + c] + tc[c]
                    acc[12 + c] = acc[12 + c] + pc[c]
        seg = torch.zeros((15, B))
        for g in range(8):
            seg = seg + acc[:, g]
        partials.append(seg)
    sums = torch.zeros((15, J, B))
    part_seg = parts.part_seg.tolist()
    for p in range(J):
        for s in range(part_seg[p], part_seg[p + 1]):
            sums[:, p] = sums[:, p] + partials[s]
    return sums[:9], sums[9:12], sums[12:]


def _k13_kernel_order(parts, lists, per_run, w, pj, homog, sd, x, dpos):
    """dh (3, V, B), dpj (12, J, B) and dx (E, B) in K13's order for a vertex
    cotangent dpos: per tile, dh by the list's projection; dx per vertex
    group as FMAs over the channels and then the group's 4 rows, the warp's
    tree over the 8 groups, the tiles of a run added in order, then the
    runs; dpj as K14's (the tests of bwd_covers) with hfull."""
    E, B = x.shape
    wz = torch.cat([w, torch.zeros((1, w.shape[1]))])
    hz, sdz, dz = _padded(homog), _padded(sd), _padded(dpos)
    verts, toff = parts.verts.tolist(), parts.tile_offset.tolist()
    tseg = parts.tile_seg.tolist()
    dh = torch.zeros_like(hz)
    hfull = torch.zeros_like(hz)
    dx = torch.zeros((E, B))
    for r0 in range(0, parts.n_tiles, per_run):
        run = torch.zeros((E, B))
        for t in range(r0, min(r0 + per_run, parts.n_tiles)):
            rows = _tiles(verts, toff[t], toff[t + 1])
            u = _blend_project(wz, pj, dz[:, rows], rows, lists[tseg[t]])
            dh[:, rows] = u
            hfull[:, rows] = _hfull(hz, sdz, x, rows)
            s = sdz[:, rows].view(3, 8, 4, E)
            xg = torch.zeros((8, E, B))
            for c in range(3):
                for i in range(4):
                    xg = _fma(s[c, :, i].unsqueeze(2), u[c].view(8, 4, B)[:, i].unsqueeze(1), xg)
            run = run + _tree8(xg)
        dx = dx + run
    tile_lists = [lists[s] for s in tseg]
    dpj = _kernel_order_dpj(w, dpos, hfull[:, :-1], verts, toff, tile_lists, per_run)
    return dh[:, :-1], dpj, dx


@pytest.fixture(scope='module')
def small_smpl():
    """The synthetic SMPL of V = 150, its part index with every 7th vertex in
    no part (the index's active lists and every joint's), and seeded operands."""
    raw, _ = synthetic.make_raw_model('smpl', num_vertices=150)
    w = torch.as_tensor(np.asarray(raw['weights']), dtype=torch.float32)
    V, J = w.shape
    pm = np.zeros((J, V), np.float32)
    pm[np.argmax(w.numpy(), axis=1), np.arange(V)] = 1
    pm[:, ::7] = 0
    parts = port_k.PartIndex.from_membership(pm, 'cpu', weights=w.numpy())
    off, joints = parts.joint_offset.tolist(), parts.joints.tolist()
    active = [joints[off[s]:off[s + 1]] for s in range(parts.n_seg)]
    every = [list(range(J))] * parts.n_seg
    assert sum(map(len, active)) < sum(map(len, every))
    rng = np.random.default_rng(11)
    t = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    E, B = 10, 3
    ops = dict(w=w, pj=t(12, J, B), homog=t(3, V, B), sd=t(3, V, E), x=t(E, B), tgt=t(3, V, B),
               dpos=t(3, V, B))
    return parts, pm, active, every, ops


def test_k4_order_over_active_joints_equals_every_joint(small_smpl):
    parts, pm, active, every, o = small_smpl
    args = (o['w'], o['pj'], o['homog'], o['sd'], o['x'], o['tgt'])
    got = _k4_kernel_order(parts, active, *args)
    for g, d in zip(got, _k4_kernel_order(parts, every, *args), strict=True):
        assert torch.equal(g, d)
    want = port_k.recon_part_sums_cached_ref(
        o['tgt'], o['pj'], o['x'], o['sd'], o['homog'], torch.as_tensor(pm), o['w'])
    for g, t in zip(got, want, strict=True):
        torch.testing.assert_close(g, t, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('per_run', [1, 4])
def test_k13_order_over_active_joints_equals_every_joint(small_smpl, per_run):
    parts, pm, active, every, o = small_smpl
    args = (o['w'], o['pj'], o['homog'], o['sd'], o['x'], o['dpos'])
    got = _k13_kernel_order(parts, active, per_run, *args)
    for g, d in zip(got, _k13_kernel_order(parts, every, per_run, *args), strict=True):
        assert torch.equal(g, d)
    # The formula: the twin's, with dpos in place of the part cotangents' pull.
    listed = torch.as_tensor(pm.any(axis=0), dtype=torch.float32).view(1, -1, 1)
    blend = torch.einsum('vj,xjb->xvb', o['w'], o['pj'])
    dh = port_k._project_rbar(blend, o['dpos']) * listed
    hfull = o['homog'] + torch.einsum('cve,eb->cvb', o['sd'], o['x'])
    hh = torch.cat([hfull, torch.ones_like(hfull[:1])])
    dpj = torch.einsum('vj,v,avb,cvb->acjb', o['w'], listed.view(-1), o['dpos'], hh)
    for g, t in zip(got, (dh, dpj.reshape(12, -1, 3), torch.einsum('cve,cvb->eb', o['sd'], dh)),
                    strict=True):
        torch.testing.assert_close(g, t, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (b) The wrappers against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def k4_calls(tmp_path_factory):
    """name -> (args, kwargs) of K4's call in a two-iteration fit of the
    synthetic model at B = 8 (SMPL-X on the kid fitter: E = 17)."""
    d = tmp_path_factory.mktemp('recon_cached')
    out = {}
    for name, (V, S, kid) in MODELS.items():
        synthetic.write_model_files(str(d), name, V, num_betas=S)
        bm = port_model(name, model_root=str(d / name))
        rng = np.random.default_rng(V)
        pose = rng.normal(0, 0.2, (BATCH, 3 * bm.num_joints)).astype(np.float32)
        betas = rng.normal(0, 1, (BATCH, bm.num_betas)).astype(np.float32)
        res = bm(pose, betas)
        fitter = BodyFitter(bm, enable_kid=kid)
        calls = record_calls(port_k, ('recon_part_sums_cached_lm',), lambda: fitter.fit(
            res['vertices'], res['joints'], num_iter=2, final_adjust_rots=False))
        out[name] = calls['recon_part_sums_cached_lm'][0]
        assert out[name][0][2].shape[0] == (17 if kid else 10)
    return out


def _np(x):
    if isinstance(x, port_k.PartIndex):
        return x.pm.numpy()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rel=JAX_REL_TOL):
    ours, theirs = _np(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * np.abs(theirs).max())


def _f64(twin, *args, **kwargs):
    """A twin evaluated in float64 (a part index by its membership)."""
    wide = lambda t: t.pm.double() if isinstance(t, port_k.PartIndex) else (  # noqa: E731
        None if t is None else t.double())
    return twin(*map(wide, args), **{k: wide(v) for k, v in kwargs.items()})


def _omega(args, form):
    """None, or seeded fit weights: static (V_pad, 1), zero past the targets'
    rows, or per call (V_t, B)."""
    if form == 'none':
        return None
    tgt, w = args[0], args[6]
    rng = np.random.default_rng(w.shape[0] + len(form))
    shape = (w.shape[0], 1) if form == 'static' else tuple(tgt.shape[1:])
    om = torch.as_tensor(rng.uniform(0.1, 2.0, shape), dtype=torch.float32)
    if form == 'static':
        om[tgt.shape[1]:] = 0.0
    return om


@pytest.mark.parametrize('form', ['none', 'static', 'call'])
@pytest.mark.parametrize('name', list(MODELS))
def test_recon_part_sums_cached_matches_jax(k4_calls, name, form):
    args, _ = k4_calls[name]
    om = _omega(args, form)
    got = port_k.recon_part_sums_cached_lm(*args, omega=om)
    want = jax_k.recon_part_sums_cached_lm(*map(_np, args), omega=None if om is None else _np(om),
                                           interpret=True)
    exact = _f64(port_k.recon_part_sums_cached_ref, *args, omega=om)
    assert len(got) == len(want) == len(exact) == 3
    for g, t, x in zip(got, want, exact):
        _close(g, t)
        _close(g, x, F64_REL_TOL)


@pytest.mark.parametrize('form', ['none', 'static'])
@pytest.mark.parametrize('name', list(MODELS))
def test_recon_part_sums_cached_bwd_matches_jax(k4_calls, name, form):
    args, _ = k4_calls[name]
    tgt, pj, x, sd, homog, parts, w = args
    om = _omega(args, form)
    J = pj.shape[1]
    rng = np.random.default_rng(J)
    cot = [torch.as_tensor(rng.normal(size=(n, J, BATCH)), dtype=torch.float32) for n in (9, 3, 3)]
    got = port_k.recon_part_sums_cached_bwd(*cot, tgt, pj, x, sd, homog, parts, w, omega=om)
    om_np = None if om is None else _np(om)
    _, vjp = jax.vjp(lambda t, p, xx, h: jax_k.recon_part_sums_cached_lm(
        t, p, xx, _np(sd), h, _np(parts), _np(w), omega=om_np, interpret=True),
        *map(_np, (tgt, pj, x, homog)))
    want = vjp(tuple(map(_np, cot)))
    exact = _f64(port_k.recon_part_sums_cached_bwd_ref, *cot, *args, omega=om)
    assert len(got) == len(want) == len(exact) == 4
    for g, t, x in zip(got, want, exact):
        _close(g, t)
        _close(g, x, F64_REL_TOL)


# ---------------------------------------------------------------------------
# (c) The wrappers' checks on the card, with nothing launched
# ---------------------------------------------------------------------------


class _Library:
    """Stands in for the kernel library: records each launch's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.endswith('_launch'):
            raise AttributeError(name)

        def launch(*args):
            self.calls[name] = args
            return 0
        return launch


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers take CPU tensors for card ones on a card of 132 SMs; the
    library records the launches."""
    lib = _Library()
    monkeypatch.setattr(port_k, '_on_cuda', lambda name, **tensors: True)
    monkeypatch.setattr(port_k, '_stream', lambda t: 0)
    monkeypatch.setattr(port_k._build, 'library', lambda: lib)
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: types.SimpleNamespace(multi_processor_count=132))
    port_k.reset_launch_counts()
    return lib


def _widened(args, E):
    """K4's operands with E shape columns (x and sd cut or tiled)."""
    tgt, pj, x, sd, homog, parts, w = args
    reps = -(-E // x.shape[0])
    return (tgt, pj, x.repeat(reps, 1)[:E].contiguous(), sd.repeat(1, 1, reps)[:, :, :E].contiguous(),
            homog, parts, w)


def test_e_above_32_is_refused(k4_calls, on_card):
    args = _widened(k4_calls['smpl'][0], 33)
    J = args[1].shape[1]
    cot = (torch.zeros((9, J, BATCH)), torch.zeros((3, J, BATCH)), torch.zeros((3, J, BATCH)))
    with torch.no_grad():
        with pytest.raises(ValueError, match='E <= 32'):
            port_k.recon_part_sums_cached_lm(*args)
        with pytest.raises(ValueError, match='E <= 32'):
            port_k.recon_part_sums_cached_bwd(*cot, *args)
    assert not on_card.calls and not any(port_k.LAUNCHES.values())


@pytest.mark.parametrize('batch', [BATCH, 4096])
def test_k13_takes_55_joints_and_its_run_plan(k4_calls, on_card, batch):
    """SMPL-X's J = 55 reaches the launch (the old kernel's J <= 64 limit is
    gone), with the part index's tiles in runs that fill one wave of the
    card: ceil(132 / column tiles) runs at most."""
    tgt, pj, x, sd, homog, parts, w = k4_calls['smplx'][0]
    reps = -(-batch // BATCH)
    wide = lambda t: t.repeat(*([1] * (t.dim() - 1)), reps)[..., :batch].contiguous()  # noqa: E731
    tgt, pj, x, homog = map(wide, (tgt, pj, x, homog))
    J, E = pj.shape[1], x.shape[0]
    cot = (torch.zeros((9, J, batch)), torch.zeros((3, J, batch)), torch.zeros((3, J, batch)))
    with torch.no_grad():
        dtgt, dpj, dx, dh = port_k.recon_part_sums_cached_bwd(*cot, tgt, pj, x, sd, homog, parts,
                                                              w)
    assert (J, E) == (55, 17) and port_k.LAUNCHES['recon_part_sums_cached_bwd'] == 1
    assert dtgt.shape == tgt.shape and dh.shape == homog.shape
    assert dpj.shape == (12, J, batch) and dx.shape == (E, batch)
    a = on_card.calls['recon_bwd_launch']
    n_tiles, n_unused, per_run = a[26:29]
    assert a[21:26] == (J, E, batch, tgt.shape[1], w.shape[0])
    assert (n_tiles, n_unused) == (parts.n_tiles, parts.unused.shape[0])
    col_tiles = -(-batch // 128)
    n_runs = -(-n_tiles // per_run)
    assert n_runs <= max(1, 132 // col_tiles) and (n_runs - 1) * per_run < n_tiles
    assert (per_run, n_runs) == port_k._segment_runs(n_tiles, batch, 'cuda', 1)


# ---------------------------------------------------------------------------
# The loader's missing vertex subset
# ---------------------------------------------------------------------------


def test_missing_vertex_subset_is_decimated_and_written(tmp_path):
    synthetic.write_model_files(str(tmp_path), 'smpl', 200)
    root = str(tmp_path / 'smpl')
    data = modeldata.initialize('smpl', 'neutral', root, vertex_subset_size=64)
    written = np.load(f'{root}/vertex_subset_64.npz')
    np.testing.assert_array_equal(data.vertex_subset, written['i_verts'])
    np.testing.assert_array_equal(data.faces, written['faces'])
    assert data.num_vertices == 64 and data.weights.shape == (64, 24)
    # A second load reads the file.
    again = modeldata.initialize('smpl', 'neutral', root, vertex_subset_size=64)
    np.testing.assert_array_equal(again.vertex_subset, data.vertex_subset)
