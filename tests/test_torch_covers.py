"""The vertex covers that K1 (``lbs_points``) and K2 (``rhs_moments*``) walk.

Both kernels walk a cover of the vertices, segments of at most 32 vertices of
one body part with each segment's active joints (``lbs_kernels.BlendSegments``
from ``wgram_cover``): ``BodyModel`` builds its own once (``lbs_cover``), the
fitter's ``GramData`` holds one (``wgram_cover``), and the reconstruction
specs carry it to K1. These tests hold, on the CPU:

- the covers of ``BodyModel`` and ``GramData`` on the synthetic SMPL, SMPL-X,
  SMPL+H (``smplh16``) and MANO models and on dense weights: every vertex
  below V once, each list exactly its segment's nonzero-weight joints;
- a torch model of K2's y in the kernel's order (a thread's 4 vertices, the
  warp's tree over 8 vertex groups, the tiles of a run, the runs), summed over
  each segment's active joints only, equal bit for bit to the same order over
  every joint;
- the checks the wrappers make of a cover, with ``_on_cuda`` patched to True
  (no launch): a cover short of the target rows or of the rows with nonzero
  weights, one past V_pad, a template with nonzero rows past an emit-form
  cover;
- ``lbs_points`` and every ``rhs_moments*`` form with ``cover=`` against the
  JAX Pallas kernels in interpret mode (small model, B = 8), and no call of
  the main path building a cover on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch import BodyFitter
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import synthetic

from port_on_cpu import port_model, port_model_from

MODELS = {'smpl': 432, 'smplx': 660, 'smplh16': 432, 'mano': 240}
REL_TOL = 2e-5  # as tests/test_torch_kernels.py: the JAX kernels split f32 dots into bf16 parts


def _check_cover(cover, w, V):
    """Every vertex below V once, segments of <= 32 vertices of one dominant
    joint, each list exactly its segment's nonzero-weight joints."""
    verts, off = cover.verts.numpy(), cover.seg_offset.numpy()
    joints, joff = cover.joints.numpy(), cover.joint_offset.numpy()
    assert cover.covers == V and np.array_equal(np.sort(verts), np.arange(V))
    dominant = np.argmax(w[:V], axis=1)
    for s in range(cover.n_seg):
        vs = verts[off[s]:off[s + 1]]
        assert 1 <= len(vs) <= 32 and len(set(dominant[vs])) == 1
        want = np.nonzero(np.any(w[vs] != 0, axis=0))[0]
        assert np.array_equal(joints[joff[s]:joff[s + 1]], want)


def _dense(bm):
    """The model's data with every joint nonzero on every vertex."""
    rng = np.random.default_rng(7)
    w = rng.uniform(0.01, 1.0, bm.model_data.weights.shape)
    return dataclasses.replace(bm.model_data, weights=(w / w.sum(axis=1, keepdims=True)))


@pytest.mark.parametrize('name', list(MODELS) + ['dense'])
def test_model_and_gram_covers(tmp_path, name):
    model = 'smplx' if name == 'dense' else name
    synthetic.write_model_files(str(tmp_path), model, MODELS[model])
    bm = port_model(model, model_root=str(tmp_path / model))
    if name == 'dense':
        bm = type(bm).from_model_data(_dense(bm), model, 'neutral', device='cpu')
    V = bm.num_vertices
    w = bm.lbs_weights_pad.numpy()
    _check_cover(bm.lbs_cover, w, V)
    fitter = BodyFitter(bm)
    gram = fitter.gram
    assert fitter.gram.wgram_cover is gram.wgram_cover  # one object: its checks are made once
    _check_cover(gram.wgram_cover, gram.weights_pad.numpy(), V)
    if name == 'dense':
        assert all(np.diff(bm.lbs_cover.joint_offset.numpy()) == bm.num_joints)


def _kernel_order_y(w, b, cover, lists, per_block):
    """y (3, J, B) of K2 in the kernel's order: per segment (one tile of 32
    rows), a thread's 4 vertices by an FMA chain, the 8 vertex groups by the
    warp's tree (xor 16, 8, 4), the tiles of a run in order, then the runs in
    order. ``lists`` gives the joints each segment adds to."""
    J, B = w.shape[1], b.shape[2]
    verts, off = cover.verts.tolist(), cover.seg_offset.tolist()
    y = torch.zeros((3, J, B))
    for r0 in range(0, cover.n_seg, per_block):
        part = torch.zeros((3, J, B))
        for s in range(r0, min(r0 + per_block, cover.n_seg)):
            rows = verts[off[s]:off[s + 1]] + [-1] * (32 - (off[s + 1] - off[s]))
            for j in lists[s]:
                groups = []
                for tm in range(8):
                    acc = torch.zeros((3, B))
                    for v in rows[4 * tm:4 * tm + 4]:
                        if v >= 0:  # fmaf(w, b, acc): one rounding, as w * b + acc in f64
                            acc = (w[v, j].double() * b[:, v].double() + acc.double()).float()
                    groups.append(acc)
                for stride in (4, 2, 1):  # the tree of reduce_scatter8
                    groups = [groups[i] + groups[i + stride] if (i // stride) % 2 == 0
                              else groups[i - stride] + groups[i] for i in range(8)]
                part[:, j] += groups[0]
        y += part
    return y


def test_y_over_active_joints_equals_dense_sum():
    raw, _ = synthetic.make_raw_model('smpl', num_vertices=200)
    w = torch.as_tensor(np.asarray(raw['weights']), dtype=torch.float32)
    V, J = w.shape
    cover = port_k.wgram_cover(w.numpy(), V, 'cpu')
    b = torch.as_tensor(np.random.default_rng(3).normal(size=(3, V, 4)), dtype=torch.float32)
    off = cover.joint_offset.tolist()
    active = [cover.joints.tolist()[off[s]:off[s + 1]] for s in range(cover.n_seg)]
    every = [list(range(J))] * cover.n_seg
    for per_block in (1, 3):
        got = _kernel_order_y(w, b, cover, active, per_block)
        assert torch.equal(got, _kernel_order_y(w, b, cover, every, per_block))
    torch.testing.assert_close(got, torch.einsum('vj,avb->ajb', w, b), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def small_calls(tmp_path_factory):
    """A forward pass and fits of a small SMPL model (V = 300) at B = 8,
    with every K1 and K2 wrapper call recorded (cover included)."""
    from chip_smoke import record_calls

    d = tmp_path_factory.mktemp('models')
    synthetic.write_model_files(str(d), 'smpl', 300)
    bm = port_model('smpl', model_root=str(d / 'smpl'))
    fitter = BodyFitter(bm)
    rng = np.random.default_rng(11)
    pose = rng.normal(0, 0.3, (8, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (8, 10)).astype(np.float32)

    def run():
        out = bm(pose, betas)
        tv, tj = out['vertices'], out['joints']
        fitter.fit(tv, tj, num_iter=1, requested_keys=('pose_rotvecs', 'vertices'))
        fitter.fit(tv, num_iter=1, scale_fit=True)
        fitter.fit_with_known_pose(torch.as_tensor(pose), tv)

    port_k.reset_launch_counts()
    calls = record_calls(port_k, ('lbs_points', 'rhs_moments_h', 'rhs_moments'), run,
                         lambda name, kw: name + ('_scale' if kw.get('scale') else ''))
    built = dict(port_k.HOST_COVERS)
    return bm, fitter, calls, built


def test_main_path_passes_its_covers(small_calls):
    bm, fitter, calls, built = small_calls
    assert set(calls) == {'lbs_points', 'rhs_moments_h', 'rhs_moments', 'rhs_moments_scale'}
    assert all(n == 0 for n in built.values())
    for key, arg_sets in calls.items():
        for _, kwargs in arg_sets:
            assert kwargs['cover'] in (bm.lbs_cover, fitter.gram.wgram_cover), key


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _check_outputs(got, ref, V):
    for g, r in zip(got, ref, strict=True):
        g, r = g.numpy(), np.asarray(r)
        if g.ndim == 3 and g.shape[1] >= V:  # per-vertex output (3, V_pad, B)
            g, r = g[:, :V], r[:, :V]
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=REL_TOL * np.max(np.abs(r)))


@pytest.mark.parametrize('key', ['lbs_points', 'rhs_moments_h', 'rhs_moments', 'rhs_moments_scale',
                                 'rhs_moments_cached', 'rhs_moments_cached_scale'])
def test_wrappers_with_cover_match_jax(small_calls, key):
    """Each form called with its cover against the JAX kernel in interpret
    mode; the cached forms on the plain form's operands with the posed
    template."""
    bm, fitter, calls, _ = small_calls
    cached = key.startswith('rhs_moments_cached')
    args, kwargs = calls[key.replace('_cached', '')][0]
    assert isinstance(kwargs['cover'], port_k.BlendSegments)
    scale = key.endswith('_scale')
    if key == 'lbs_points':
        got = (port_k.lbs_points(*args, cover=kwargs['cover']),)
        ref = (jax_k.lbs_points(*map(_np, args), interpret=True),)
    elif key == 'rhs_moments_h':
        got = port_k.rhs_moments_h(*args, **kwargs)
        ref = jax_k.rhs_moments_h(*map(_np, args), interpret=True)
    elif not cached:
        got = port_k.rhs_moments(*args, **kwargs)
        ref = jax_k.rhs_moments(*map(_np, args), scale=scale, interpret=True)
    else:
        tgt, pj, feat, w, consts, sd = args
        homog = port_k.posed_template_ref(feat, consts)
        got = port_k.rhs_moments_cached(tgt, pj, homog, w, sd, **kwargs)
        ref = jax_k.rhs_moments_cached(_np(tgt), _np(pj), _np(homog), _np(w), _np(sd),
                                       scale=scale, interpret=True)
    _check_outputs(got, ref, bm.num_vertices)


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers take CPU tensors for card ones; any launch fails."""
    def no_launch():
        raise AssertionError('a kernel launch was attempted')

    monkeypatch.setattr(port_k, '_on_cuda', lambda name, **tensors: True)
    monkeypatch.setattr(port_k._build, 'library', no_launch)


def test_cover_checks_on_the_card(small_calls, on_card):
    bm, fitter, calls, _ = small_calls
    V = bm.num_vertices
    k1_args, _ = calls['lbs_points'][0]
    pj, feat, w, consts = k1_args
    short = port_k.wgram_cover(w.numpy(), V - 5, 'cpu')
    with pytest.raises(ValueError, match='nonzero rows'):
        port_k.lbs_points(pj, feat, w, consts, cover=short)
    past = port_k.wgram_cover(np.concatenate([w.numpy(), w.numpy()[:1]]), w.shape[0] + 1, 'cpu')
    with pytest.raises(ValueError, match='the cover holds'):
        port_k.lbs_points(pj, feat, w, consts, cover=past)
    (tgt, pj2, feat2, w2, consts2, sd), kw = calls['rhs_moments'][0]
    with pytest.raises(ValueError, match='the cover holds'):
        port_k.rhs_moments(tgt, pj2, feat2, w2, consts2, sd, cover=short)
    homog = port_k.posed_template_ref(feat2, consts2)
    with pytest.raises(ValueError, match='the cover holds'):
        port_k.rhs_moments_cached(tgt, pj2, homog, w2, sd, scale=True, cover=short)
    noisy = consts2.clone()
    noisy[:3, V:] = 1.0
    with pytest.raises(ValueError, match='nonzero rows'):
        port_k.rhs_moments_h(tgt, pj2, feat2, w2, noisy, sd, cover=kw['cover'])
    assert all(n == 0 for n in port_k.LAUNCHES.values())


def test_missing_cover_is_built_and_counted(small_calls, on_card, monkeypatch):
    """A call on the card without a cover builds one of every V_pad row on
    the host and counts it; the main path never does (see above)."""
    built = {}

    def spy(weights, num_vertices, device):
        built['rows'] = num_vertices
        raise RuntimeError('built')

    monkeypatch.setattr(port_k, 'wgram_cover', spy)
    port_k.reset_launch_counts()
    args, _ = small_calls[2]['lbs_points'][0]
    with pytest.raises(RuntimeError, match='built'):
        port_k.lbs_points(*args)
    assert port_k.HOST_COVERS['lbs_points'] == 1 and built['rows'] == args[2].shape[0]


def test_cpu_calls_take_no_k2_loop(small_calls):
    """K2's twins launch nothing: a CPU call counts under neither of
    ``K2_PIPELINE``'s loops, and ``reset_launch_counts`` zeroes them."""
    args, kwargs = small_calls[2]['rhs_moments_h'][0]
    port_k.K2_PIPELINE['overlapped'] += 1
    port_k.reset_launch_counts()
    assert port_k.K2_PIPELINE == {'overlapped': 0, 'serial': 0}
    with torch.no_grad():
        port_k.rhs_moments_h(*args, **kwargs)
    assert port_k.K2_PIPELINE == {'overlapped': 0, 'serial': 0}
    assert port_k.LAUNCHES['rhs_moments_h'] == 0


def test_model_copy_keeps_its_cover(small_calls):
    bm = small_calls[0]
    copy = port_model_from(bm)
    for field in ('verts', 'seg_offset', 'joints', 'joint_offset'):
        assert torch.equal(getattr(copy.lbs_cover, field), getattr(bm.lbs_cover, field))
