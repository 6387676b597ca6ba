"""K11 (``rhs_moments_bwd``) and K12 (``rhs_moments_cached_bwd``) on the
cover that their forward K2 walked, on the CPU.

Both are fronts on ``csrc/bwd_front.cuh`` over K2's cover
(``lbs_kernels.BlendSegments``, passed on by ``_RhsMoments`` as ``cover=``);
per segment they blend over its active joints only and sum dpj's two rank-1
fields, -db h and G b, in one warp reduce-scatter per joint. These tests
hold, on the CPU:

- a torch model of that dpj order (both fields per thread, the warp's tree,
  the segments of a run, the runs) over each segment's active joints, equal
  bit for bit to the same order over every joint, on a cover with static ω
  and V_t < V < V_pad;
- ``rhs_moments_bwd(cover=)`` (emit with ``gh``, plain) on SMPL (V = 432)
  and MANO (V = 240) and
  ``rhs_moments_cached_bwd(cover=)`` on SMPL-X (V = 660), unweighted and
  static ω, B = 8, against ``jax.vjp`` of the JAX package's K2 in interpret
  mode within JAX_REL_TOL x max|JAX|, and against the twin's formula in
  float64 within F64_REL_TOL;
- that ``_RhsMoments.backward`` passes the forward's cover on (and the emit
  form's the template's cotangent, the plain form's none); in a fit's
  gradient, the fitter's own cover;
- the wrappers' checks with ``_on_cuda`` patched to True and a stand-in
  library (nothing launches): a cover short of V_t or past V_pad raises, a
  call without a cover builds one on the host (counted), J = 55 reaches the
  launch with a run plan of one wave (K11 with its template workspace, K12
  with the cached template), E = 33 is refused.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from chip_smoke import record_calls
from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch import BodyFitter, get_fit_grad_fn
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import synthetic
from test_torch_bwd_covers import _kernel_order_dpj
from test_torch_recon_cached import on_card  # noqa: F401  (the fixture: a stand-in library)

from port_on_cpu import port_model

BATCH = 8
# The wrappers against the JAX kernels in interpret mode, x max|JAX| per
# output (f32 sums in another order; the JAX kernels split each f32 dot into
# bf16 parts, as in tests/test_torch_grad_kernels.py).
JAX_REL_TOL = 1e-5
# The wrappers against their twin's formula evaluated in float64.
F64_REL_TOL = 1e-6
# model -> (V, K2 wrapper of its headline fit)
MODELS = {'smpl': (432, 'rhs_moments_h'), 'smplx': (660, 'rhs_moments_cached'),
          'mano': (240, 'rhs_moments_h')}


# ---------------------------------------------------------------------------
# The front's dpj order over the active joints
# ---------------------------------------------------------------------------


def test_two_field_dpj_order_over_active_joints_equals_every_joint():
    raw, _ = synthetic.make_raw_model('smpl', num_vertices=150)
    w = np.asarray(raw['weights'], np.float32)
    V, J = w.shape
    Vp, v_t, E, B = 256, 131, 10, 3
    wp = torch.zeros((Vp, J))
    wp[:V] = torch.as_tensor(w)
    cover = port_k.wgram_cover(wp.numpy(), V, 'cpu')
    rng = np.random.default_rng(12)
    t = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    gr, gy, tgt, pj, homog, sd = t(E, B), t(3, J, B), t(3, v_t, B), t(12, J, B), t(3, Vp, B), \
        t(3, Vp, E)
    om = torch.as_tensor(rng.uniform(0.1, 2.0, (Vp, 1)), dtype=torch.float32)
    om[::9] = 0.0
    # The fields of the twin's formula: zero past V_t, ω-weighted.
    omv = torch.zeros((Vp, 1))
    omv[:v_t] = om[:v_t]
    blend = torch.einsum('vj,xjb->xvb', wp, pj)
    G = torch.einsum('cve,eb->cvb', sd, gr)
    db = (torch.einsum('vj,ajb->avb', wp, gy)
          + torch.stack([sum(blend[a * 4 + c] * G[c] for c in range(3)) for a in range(3)])) * omv
    tz = torch.zeros((3, Vp, B))
    tz[:, :v_t] = tgt
    b = (tz - port_k._apply_blend(blend, homog)) * omv
    off, joints = cover.joint_offset.tolist(), cover.joints.tolist()
    active = [joints[off[s]:off[s + 1]] for s in range(cover.n_seg)]
    every = [list(range(J))] * cover.n_seg
    assert sum(map(len, active)) < sum(map(len, every))
    verts, seg_offset = cover.verts.tolist(), cover.seg_offset.tolist()
    for per_run in (1, 4):
        got = _kernel_order_dpj(wp, -db, homog, verts, seg_offset, active, per_run, b, G)
        assert torch.equal(got, _kernel_order_dpj(wp, -db, homog, verts, seg_offset, every,
                                                  per_run, b, G))
    _, want, _ = port_k.rhs_moments_cached_bwd_ref(gr, gy, tgt, pj, homog, wp, sd, omega=om)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The wrappers against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def k2_calls(tmp_path_factory):
    """name -> (fitter, (args, kwargs) of K2's call in a one-iteration fit
    of the synthetic model at B = 8: the emit form on SMPL and MANO, the
    cached form on SMPL-X)."""
    d = tmp_path_factory.mktemp('rhs_bwd')
    out = {}
    for name, (V, wrapper) in MODELS.items():
        synthetic.write_model_files(str(d), name, V)
        bm = port_model(name, model_root=str(d / name))
        rng = np.random.default_rng(V)
        pose = rng.normal(0, 0.2, (BATCH, 3 * bm.num_joints)).astype(np.float32)
        betas = rng.normal(0, 1, (BATCH, bm.num_betas)).astype(np.float32)
        res = bm(pose, betas)
        fitter = BodyFitter(bm)
        calls = record_calls(port_k, (wrapper,), lambda: fitter.fit(
            res['vertices'], res['joints'], num_iter=1, final_adjust_rots=False))
        out[name] = (fitter, calls[wrapper][0])
        assert out[name][1][1]['cover'] is fitter.gram.wgram_cover
    return out


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rel=JAX_REL_TOL, rows=None):
    ours, theirs = _np(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    if rows is not None:
        ours, theirs = ours[rows], theirs[rows]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * np.abs(theirs).max())


def _f64(twin, *args, **kwargs):
    wide = lambda t: None if t is None else t.double()  # noqa: E731
    return twin(*map(wide, args), **{k: wide(v) for k, v in kwargs.items()})


def _static_omega(tgt, w):
    """Seeded static fit weights (V_pad, 1), zero past the targets' rows and
    at every 7th row."""
    om = torch.as_tensor(np.random.default_rng(w.shape[0]).uniform(0.1, 2.0, (w.shape[0], 1)),
                         dtype=torch.float32)
    om[tgt.shape[1]:] = 0.0
    om[::7] = 0.0
    return om


def _cotangents(E, J, Vp, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    return t(E, BATCH), t(3, J, BATCH), t(3, Vp, BATCH)


@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('name, form', [('smpl', 'emit'), ('smpl', 'plain'), ('mano', 'emit'),
                                        ('mano', 'plain')])
def test_rhs_moments_bwd_matches_jax(k2_calls, name, form, omega):
    _, ((tgt, pj, feat, w, consts, sd), kw) = k2_calls[name]
    om = _static_omega(tgt, w) if omega else None
    gr, gy, gh = _cotangents(sd.shape[2], pj.shape[1], w.shape[0], len(name))
    emit = form == 'emit'
    got = port_k.rhs_moments_bwd(gr, gy, tgt, pj, feat, w, consts, sd, gh=gh if emit else None,
                                 omega=om, cover=kw['cover'])
    om_np = None if om is None else _np(om)
    fn = jax_k.rhs_moments_h if emit else jax_k.rhs_moments
    _, vjp = jax.vjp(lambda t, p, f: fn(t, p, f, _np(w), _np(consts), _np(sd), omega=om_np,
                                        interpret=True), *map(_np, (tgt, pj, feat)))
    want = vjp((_np(gr), _np(gy)) + ((_np(gh),) if emit else ()))
    exact = _f64(port_k.rhs_moments_bwd_ref, gr, gy, tgt, pj, feat, w, consts, sd,
                 gh=gh if emit else None, omega=om)
    # dfeat: every row but the homogeneous constant's, which the JAX VJP
    # also contracts with consts[3] (tests/test_torch_grad_kernels.py)
    feat_rows = ~np.any(_np(consts)[3] != 0, axis=0)
    assert len(got) == len(want) == len(exact) == 3
    for i, (g, t, x) in enumerate(zip(got, want, exact)):
        _close(g, t, rows=feat_rows if i == 2 else None)
        _close(g, x, F64_REL_TOL)


@pytest.mark.parametrize('omega', [False, True])
def test_rhs_moments_cached_bwd_matches_jax(k2_calls, omega):
    _, ((tgt, pj, homog, w, sd), kw) = k2_calls['smplx']
    om = _static_omega(tgt, w) if omega else None
    gr, gy, _ = _cotangents(sd.shape[2], pj.shape[1], w.shape[0], 5)
    got = port_k.rhs_moments_cached_bwd(gr, gy, tgt, pj, homog, w, sd, omega=om,
                                        cover=kw['cover'])
    om_np = None if om is None else _np(om)
    _, vjp = jax.vjp(lambda t, p, h: jax_k.rhs_moments_cached(
        t, p, h, _np(w), _np(sd), omega=om_np, interpret=True), *map(_np, (tgt, pj, homog)))
    want = vjp((_np(gr), _np(gy)))
    exact = _f64(port_k.rhs_moments_cached_bwd_ref, gr, gy, tgt, pj, homog, w, sd, omega=om)
    assert len(got) == len(want) == len(exact) == 3
    for g, t, x in zip(got, want, exact):
        _close(g, t)
        _close(g, x, F64_REL_TOL)


# ---------------------------------------------------------------------------
# The autograd Function's wiring
# ---------------------------------------------------------------------------


@pytest.fixture
def spies(monkeypatch):
    """The keyword arguments of every K11 and K12 call."""
    seen = []
    for wrapper in ('rhs_moments_bwd', 'rhs_moments_cached_bwd'):
        original = getattr(port_k, wrapper)

        def spy(*args, _original=original, **kwargs):
            seen.append(kwargs)
            return _original(*args, **kwargs)

        monkeypatch.setattr(port_k, wrapper, spy)
    return seen


@pytest.mark.parametrize('form', ['emit', 'plain', 'cached'])
def test_backward_gets_the_forward_cover(k2_calls, spies, form):
    name = 'smplx' if form == 'cached' else 'smpl'
    _, (args, _) = k2_calls[name]
    w = args[3]
    other = port_k.wgram_cover(w.numpy(), w.shape[0], 'cpu')
    tgt = args[0].detach().requires_grad_()
    if form == 'cached':
        out = port_k.rhs_moments_cached(tgt, *args[1:], cover=other)
    elif form == 'emit':
        out = port_k.rhs_moments_h(tgt, *args[1:], cover=other)
    else:
        out = port_k.rhs_moments(tgt, *args[1:], cover=other)
    sum(o.sum() for o in out).backward()
    (kw,) = spies
    assert kw['cover'] is other and tgt.grad is not None
    if form != 'cached':
        assert (kw['gh'] is not None) == (form == 'emit')


@pytest.mark.parametrize('name', ['smpl', 'smplx'])
def test_fit_gradient_walks_the_fitter_cover(k2_calls, spies, name):
    fitter, ((tgt, *_), _) = k2_calls[name]
    tj = torch.zeros((3, fitter.body_model.num_joints, BATCH)).permute(2, 1, 0)
    get_fit_grad_fn(fitter, num_iter=1)(tgt.permute(2, 1, 0)[:, :fitter.body_model.num_vertices],
                                        tj.contiguous())
    assert spies and all(kw['cover'] is fitter.gram.wgram_cover for kw in spies)


# ---------------------------------------------------------------------------
# The wrappers' checks on the card, with nothing launched
# ---------------------------------------------------------------------------


def _k12_args(k2_calls):
    """K12's operands of the SMPL-X call (J = 55) and cotangents."""
    _, ((tgt, pj, homog, w, sd), kw) = k2_calls['smplx']
    gr, gy, _ = _cotangents(sd.shape[2], pj.shape[1], w.shape[0], 9)
    return (gr, gy, tgt, pj, homog, w, sd), kw['cover']


def test_cover_checks_on_the_card(k2_calls, on_card):
    args, _ = _k12_args(k2_calls)
    w, v_t = args[5], args[2].shape[1]
    short = port_k.wgram_cover(w.numpy(), v_t - 3, 'cpu')
    past = port_k.wgram_cover(np.concatenate([w.numpy(), w.numpy()[:1]]), w.shape[0] + 1, 'cpu')
    with torch.no_grad():
        for cover in (short, past):
            with pytest.raises(ValueError, match='the cover holds'):
                port_k.rhs_moments_cached_bwd(*args, cover=cover)
    assert not on_card.calls and not any(port_k.LAUNCHES.values())


def test_missing_cover_is_built_and_counted(k2_calls, on_card, monkeypatch):
    built = {}

    def spy(weights, num_vertices, device):
        built['rows'] = num_vertices
        raise RuntimeError('built')

    monkeypatch.setattr(port_k, 'wgram_cover', spy)
    args, _ = _k12_args(k2_calls)
    with pytest.raises(RuntimeError, match='built'):
        port_k.rhs_moments_cached_bwd(*args)
    assert port_k.HOST_COVERS['rhs_moments_bwd'] == 1 and built['rows'] == args[5].shape[0]


@pytest.mark.parametrize('batch', [BATCH, 4096])
@pytest.mark.parametrize('form', ['emit', 'plain', 'cached'])
def test_55_joints_reach_the_launch_with_one_wave_of_runs(k2_calls, on_card, form, batch):
    """SMPL-X's J = 55 reaches the launch (the old kernel's J <= 64 limit is
    gone), with the cover's segments in runs that fill one wave of the card;
    K11 with a template workspace (K7's, then dh), K12 with the cached
    template."""
    (gr, gy, tgt, pj, homog, w, sd), cover = _k12_args(k2_calls)
    reps = -(-batch // BATCH)
    wide = lambda t: t.repeat(*([1] * (t.dim() - 1)), reps)[..., :batch].contiguous()  # noqa: E731
    gr, gy, tgt, pj, homog = map(wide, (gr, gy, tgt, pj, homog))
    J, E, Vp = pj.shape[1], sd.shape[2], w.shape[0]
    F = 487
    with torch.no_grad():
        if form == 'cached':
            out = port_k.rhs_moments_cached_bwd(gr, gy, tgt, pj, homog, w, sd, cover=cover)
        else:
            feat, consts = torch.zeros((F, batch)), torch.zeros((4, Vp, F))
            kw = dict(gh=homog) if form == 'emit' else {}
            out = port_k.rhs_moments_bwd(gr, gy, tgt, pj, feat, w, consts, sd, cover=cover, **kw)
    key = {'emit': 'rhs_moments_h_bwd', 'plain': 'rhs_moments_bwd',
           'cached': 'rhs_moments_cached_bwd'}[form]
    assert J == 55 and port_k.LAUNCHES[key] == 1 and sum(port_k.LAUNCHES.values()) == 1
    assert out[0].shape == tgt.shape and out[1].shape == (12, J, batch)
    assert out[2].shape == ((3, Vp, batch) if form == 'cached' else (F, batch))
    a = on_card.calls['rhs_bwd_launch']
    assert a[20:28] == (J, batch, 0 if form == 'cached' else F, E, tgt.shape[1], Vp,
                        cover.n_seg, cover.covers)
    per_run, splits = a[28:30]
    cached = form == 'cached'
    assert (a[2] is None) == (form != 'emit') and (a[10] is None) == (not cached)
    assert splits == (1 if cached else port_k.dfeat_splits(F, batch, Vp, 'cuda'))
    n_runs = -(-cover.n_seg // per_run)
    assert n_runs <= max(1, 132 // -(-batch // 128)) and (n_runs - 1) * per_run < cover.n_seg
    assert (per_run, n_runs) == port_k._segment_runs(cover.n_seg, batch, 'cuda', 1)


def test_e_above_32_is_refused(k2_calls, on_card):
    (gr, gy, tgt, pj, homog, w, sd), cover = _k12_args(k2_calls)
    reps = -(-33 // sd.shape[2])
    sd33 = sd.repeat(1, 1, reps)[:, :, :33].contiguous()
    gr33 = gr.repeat(reps, 1)[:33].contiguous()
    feat, consts = torch.zeros((7, BATCH)), torch.zeros((4, w.shape[0], 7))
    with torch.no_grad():
        with pytest.raises(ValueError, match='E <= 32'):
            port_k.rhs_moments_cached_bwd(gr33, gy, tgt, pj, homog, w, sd33, cover=cover)
        with pytest.raises(ValueError, match='E <= 32'):
            port_k.rhs_moments_bwd(gr33, gy, tgt, pj, feat, w, consts, sd33, cover=cover)
    assert not on_card.calls and not any(port_k.LAUNCHES.values())
