"""The refiner's step as a public method, ``BodyFitterOpt.loss_and_grad``, on
the CPU, and the benchmark's readers of it.

- Against the plain float64 reference (``portbench/reference_refine.py``) at
  B=8 on the benchmark's synthetic ``smpl`` and ``smplx`` at their published
  widths, inputs drawn by the benchmark's ``refine_grad`` entry: each
  gradient within REL_TOL x its largest reference component, the loss within
  LOSS_REL. The port poses in float32: its vertices (about 1 m from the
  origin) carry rounding of about 1e-7 m against distances to the targets
  of 1e-2 m and more, so the unit directions the gradient sums carry about
  1e-5 at the worst and 1e-6 typically.
- ``fit(refine_steps=4)`` equal bit for bit to the refinement as it was
  written before ``loss_and_grad`` (``_refine_before``, below), with and
  without per-call weights and the kid factor.
- The spans under ``torch.profiler``: ``refine`` around ``refine.loss``
  (holding the forward pass's ``forward``) and ``refine.backward``, with K1's
  launch under ``refine.loss`` and K10's under ``refine.backward`` (on the
  CPU the twins run, so the test counts the wrappers' calls).
- The work count of ``portbench/work/refine_grad.py`` against the port's
  smoke-test yardstick (``chip_smoke.kernel_work``) on the operands the step
  hands K1 and K10, within 1% (the kernels' rows are padded to 256).
- The four readers of the cell ``smplx-refine-grad`` on hand-made span
  records and a hand-made reading.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smplfitter_tpu_torch import BodyModel
from smplfitter_tpu_torch.models import bodyfitter_opt
from smplfitter_tpu_torch.models.bodyfitter_opt import BodyFitterOpt
from smplfitter_tpu_torch.models.bodymodel import fk_rotations
from smplfitter_tpu_torch.ops import lbs_kernels
from smplfitter_tpu_torch.ops import rotation as rot_ops
from smplfitter_tpu_torch.utils import profiling, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, refine_spans, synth, trace  # noqa: E402
from portbench.reference import RefModel  # noqa: E402
from portbench.reference_refine import refine_grads, refine_loss  # noqa: E402
from portbench.work import refine_grad as work  # noqa: E402

REL_TOL = 1e-5
LOSS_REL = 1e-6
WORK_REL = 0.01
BATCH = 8
CELL = 'smplx-refine-grad'
TRAFFIC = 'refine-grad-b49152'
METRICS = ('loss_stream_ms', 'bwd_stream_ms', 'k10_roofline', 'grad_call_mfu')


@pytest.fixture(scope='module')
def bench_models(tmp_path_factory):
    """{config: (cell, port's refiner, float32 and float64 references, one
    input set of B=8 drawn by the cell's entry)} on the CPU."""
    cache = str(tmp_path_factory.mktemp('bench_models'))
    out = {}
    for name in ('smpl', 'smplx'):
        spec = harness.make_cell(ROOT, f'{name}-refine-grad', f'portbench/configs/{name}.json',
                                 TRAFFIC)
        cfg = spec.config
        root = synth.ensure_model_files(cache, cfg)
        bm = BodyModel(cfg['model'], cfg['gender'], model_root=root, num_betas=cfg['num_betas'],
                       device='cpu')
        refs = [RefModel(root, cfg['model'], cfg['num_betas'], 'cpu', dt)
                for dt in (torch.float32, torch.float64)]
        ctx = SimpleNamespace(config=cfg, traffic=dict(spec.traffic, batch=BATCH, target_sets=1),
                              device='cpu')
        inp = spec.entry.make_inputs(ctx, refs[0], torch.Generator().manual_seed(2 ** 31 + 7))[0]
        out[name] = (spec, BodyFitterOpt(bm), refs, inp)
    return out


def _params(inp):
    return {k: inp[k] for k in ('rot6d', 'betas', 'trans')}


@pytest.mark.parametrize('config', ['smpl', 'smplx'])
def test_loss_and_grad_matches_reference(bench_models, config):
    spec, opt, (_, ref64), inp = bench_models[config]
    reg = spec.traffic['refine']['beta_regularizer']
    loss, grads = opt.loss_and_grad(_params(inp), inp['target_vertices'], inp['target_joints'],
                                    beta_regularizer=reg)
    assert list(grads) == ['rot6d', 'betas', 'trans']
    want = refine_grads(ref64, _params(inp), inp['target_vertices'], inp['target_joints'],
                        BATCH, reg)
    for k, g in grads.items():
        assert g.shape == inp[k].shape and g.dtype == torch.float32
        scale = want[k].abs().max().item()
        gap = (g.double() - want[k]).abs().max().item()
        assert gap <= REL_TOL * scale, (k, gap, scale)
    want_loss = refine_loss(ref64, {k: v.double() for k, v in _params(inp).items()},
                            inp['target_vertices'].double(), inp['target_joints'].double(),
                            BATCH, reg).item()
    assert abs(loss.item() - want_loss) <= LOSS_REL * want_loss


def test_entry_gaps_read_the_reference(bench_models):
    """The cell's check on the CPU: the port's gradients of the sampled rows
    against the reference's, per row relative to its largest component."""
    spec, opt, (_, ref64), inp = bench_models['smplx']
    tr = dict(spec.traffic, batch=BATCH)
    out, rows_in = spec.entry.rows_of(spec.entry.call(opt, inp, tr), inp, torch.arange(BATCH))
    gaps = spec.entry.gaps(out, spec.entry.reference(ref64, rows_in, tr), ref64)
    assert set(gaps) == {'grad_rot6d_gap', 'grad_betas_gap', 'grad_trans_gap'}
    for name, g in gaps.items():
        assert g.shape == (BATCH,) and 0 < g.max().item() <= REL_TOL, (name, g)


def test_work_matches_kernel_work(bench_models):
    sys.path.insert(0, ROOT)
    import chip_smoke

    spec, opt, (ref32, _), inp = bench_models['smplx']
    tr = dict(spec.traffic, batch=BATCH)
    calls = chip_smoke.record_calls(lbs_kernels, ['lbs_points', 'lbs_points_bwd'],
                                    lambda: spec.entry.call(opt, inp, tr))
    counted = {name: (f, b) for name, f, b in work.stages(harness.shapes(ref32, tr))}
    assert set(counted) == set(calls)
    for name, recorded in calls.items():
        (args, kwargs), = recorded
        for c, r in zip(counted[name], chip_smoke.kernel_work(name, args, kwargs)):
            assert abs(c - r) <= WORK_REL * r, (name, c, r)


# --- the refinement, bit for bit ---------------------------------------------


def _refine_before(opt, tv, tj, vw, jw, init, beta_regularizer, num_steps, lr, warmup_ratio):
    """``BodyFitterOpt._refine`` as it was before ``loss_and_grad``: the loss
    a closure, ``.backward()`` into the parameters' ``.grad``."""
    bm = opt.body_model
    num_joints = bm.num_joints
    tv, tj, vw, jw = (None if x is None else bm.as_f32(x).detach() for x in (tv, tj, vw, jw))
    with torch.no_grad():
        init_rel = rot_ops.rotvec2mat(bm.as_f32(init['pose_rotvecs']).reshape(-1, num_joints, 3))
        init_glob = fk_rotations(bm.kintree_parents, init_rel)
    params = dict(rot6d=rot_ops.rotmat_to_rot6d(init_glob), betas=init['shape_betas'],
                  trans=init['trans'])
    if init.get('kid_factor') is not None:
        params['kid'] = init['kid_factor']
    params = {k: bm.as_f32(v).detach().clone().requires_grad_() for k, v in params.items()}

    def loss_fn(p):
        res = bm(glob_rotmats=rot_ops.rot6d_to_rotmat(p['rot6d']), shape_betas=p['betas'],
                 trans=p['trans'], kid_factor=p.get('kid'))
        v_diff_norm = torch.linalg.norm(res['vertices'] - tv, dim=-1)
        loss = torch.mean(vw * v_diff_norm) if vw is not None else torch.mean(v_diff_norm)
        if tj is not None:
            j_diff_norm = torch.linalg.norm(res['joints'] - tj, dim=-1)
            loss = loss + (torch.mean(jw * j_diff_norm) if jw is not None
                           else torch.mean(j_diff_norm))
        if beta_regularizer > 0 and p['betas'].shape[1] > 2:
            loss = loss + beta_regularizer * torch.mean(p['betas'][:, 2:] ** 2)
        return loss

    schedule = bodyfitter_opt.refine_schedule(num_steps, lr, warmup_ratio)
    optimizer = torch.optim.Adam(list(params.values()), lr=0.0,
                                 betas=bodyfitter_opt.ADAM_BETAS, eps=bodyfitter_opt.ADAM_EPS)
    for k in range(num_steps):
        for group in optimizer.param_groups:
            group['lr'] = schedule(k)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss_fn(params).backward()
        optimizer.step()
    with torch.no_grad():
        glob_final = rot_ops.rot6d_to_rotmat(params['rot6d'])
        parents = torch.tensor(bm.kintree_parents[1:])
        parent_glob = torch.cat([torch.eye(3).expand(glob_final.shape[0], 1, 3, 3),
                                 glob_final[:, parents]], dim=1)
        rel = rot_ops.matmul3x3(parent_glob, glob_final, transpose_a=True)
        pose_rotvecs = rot_ops.mat2rotvec(rel).reshape(glob_final.shape[0], num_joints * 3)
    out = dict(pose_rotvecs=pose_rotvecs, shape_betas=params['betas'].detach(),
               trans=params['trans'].detach())
    if 'kid' in params:
        out['kid_factor'] = params['kid'].detach()
    return out


@pytest.fixture(scope='module')
def small_smpl(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('body_models'))
    synthetic.write_model_files(d, 'smpl', 500)
    bm = BodyModel('smpl', 'neutral', model_root=d + '/smpl', device='cpu')
    rng = np.random.default_rng(11)
    pose = torch.tensor(rng.normal(0, 0.2, (6, 72)), dtype=torch.float32)
    betas = torch.tensor(rng.normal(0, 1, (6, 10)), dtype=torch.float32)
    out = bm(pose, betas, torch.tensor(rng.normal(0, 0.5, (6, 3)), dtype=torch.float32))
    weights = (torch.tensor(rng.uniform(0.1, 2.0, (6, bm.num_vertices)), dtype=torch.float32),
               torch.tensor(rng.uniform(0.1, 2.0, (6, bm.num_joints)), dtype=torch.float32))
    return bm, out['vertices'], out['joints'], weights


@pytest.mark.parametrize('weighted_kid', [False, True])
def test_refine_steps_equal_the_refinement_before(small_smpl, weighted_kid):
    bm, tv, tj, (vw, jw) = small_smpl
    if not weighted_kid:
        vw = jw = None
    opt = BodyFitterOpt(bm, enable_kid=weighted_kid)
    kw = dict(num_iter=2, beta_regularizer=1.0)
    got = opt.fit(tv, tj, vw, jw, refine_steps=4, refine_lr=0.01, **kw)
    init = opt.fitter.fit(tv, tj, vertex_weights=vw, joint_weights=jw, final_adjust_rots=False,
                          requested_keys=('pose_rotvecs', 'shape_betas', 'trans'), **kw)
    want = _refine_before(opt, tv, tj, vw, jw, init, 1.0, 4, 0.01, 0.5)
    assert got.keys() == want.keys()
    assert ('kid_factor' in got) == weighted_kid
    for key in want:
        assert torch.equal(got[key], want[key]), key


# --- the spans ---------------------------------------------------------------


def test_spans_of_a_step(bench_models, monkeypatch):
    spec, opt, _, inp = bench_models['smpl']
    for name, key in (('lbs_points', 'lbs_points'), ('lbs_points_bwd', 'lbs_points_bwd')):
        def counted(*args, _fn=getattr(lbs_kernels, name), _key=key, **kwargs):
            lbs_kernels.LAUNCHES[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(lbs_kernels, name, counted)
    monkeypatch.setattr(lbs_kernels, 'LAUNCHES', dict(lbs_kernels.LAUNCHES))
    profiling.clear_spans()
    opt.loss_and_grad(_params(inp), inp['target_vertices'], inp['target_joints'])
    assert profiling.spans() == []  # nothing recorded without the profiler
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            opt.loss_and_grad(_params(inp), inp['target_vertices'], inp['target_joints'])
    recs = profiling.spans()
    assert [r['name'] for r in recs] == ['forward', 'refine.loss', 'refine.backward',
                                         'refine'] * 2
    for call in (recs[:4], recs[4:]):
        fwd, loss, bwd, outer = call
        assert outer['parent'] is None
        assert loss['parent'] == bwd['parent'] == outer['index']
        assert fwd['parent'] == loss['index']
        assert {r['call'] for r in call} == {outer['index']}
        assert (loss['launches'], bwd['launches'], outer['launches']) == (1, 1, 2)
        assert loss['host_start_ns'] <= loss['host_end_ns'] <= bwd['host_start_ns']
    assert refine_spans.calls(recs) == 2
    profiling.clear_spans()


# --- the readers -------------------------------------------------------------


def _rec(index, name, parent, call, stream_ms):
    return dict(index=index, name=name, parent=parent, call=call,
                marks=[f'{name}#{index}>', f'{name}#{index}<'], host_start_ns=0,
                host_end_ns=1, stream_ms=stream_ms, launches=0, torch_vjps=0, host_covers=0,
                k2_overlapped=0)


def _two_steps():
    recs = []
    for base, (loss_ms, bwd_ms) in ((0, (40.0, 110.0)), (10, (44.0, 118.0))):
        recs += [_rec(base + 2, 'forward', base + 1, base, loss_ms - 1),
                 _rec(base + 1, 'refine.loss', base, base, loss_ms),
                 _rec(base + 3, 'refine.backward', base, base, bwd_ms),
                 _rec(base, 'refine', None, base, loss_ms + bwd_ms + 0.5)]
    return recs


SHAPES = dict(B=1000, V=10475, J=55, E=16, P=486, nnz=30000, used=9000, nnz_used=28000,
              num_iter=1, weighted=False)
# Device events of two steps (us): K1, torch ops, and K10's four kernels,
# named as the profiler names them, with one of K10's kernels twice a step.
EVENTS = [('void (anonymous namespace)::lbs_points_kernel<true>(float const*)', 0, 50, True),
          ('void at::native::elementwise_kernel<128, 2>()', 50, 80, False),
          ('void (anonymous namespace)::posed_template_kernel<true>(float const*)', 80, 100, True),
          ('void (anonymous namespace)::lbs_points_bwd_front<true>(float const*)', 100, 160, True),
          ('void split_sum_kernel(float const*, float*, int, unsigned long)', 160, 170, True),
          ('void (anonymous namespace)::dfeat_gemm_kernel(float const*)', 170, 200, True),
          ('void split_sum_kernel(float const*, float*, int, unsigned long)', 200, 210, True),
          ('Memset (Device)', 210, 212, False)]
K10_US_PER_STEP = 130.0


def _reading():
    events = EVENTS + [(n, s + 1000, e + 1000, p) for n, s, e, p in EVENTS]
    return SimpleNamespace(calls=2, host=[], events=events, flops=3.0e12, wall_s_per_call=0.2,
                           peak_flops=67e12, busy_s=2 * 212e-6, window_s=1.0)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(refine_spans, 'cell_shapes', dict(SHAPES))

    def use(recs):
        monkeypatch.setattr(profiling, 'spans', lambda: recs)
    return use


def _values():
    spec = harness.load_cell(ROOT, CELL)
    assert [m['name'] for m in spec.per_layer] == list(METRICS)
    return {k: v['value'] for k, v in trace.per_layer_values(spec, _reading()).items()}


def test_readers_of_two_steps(recorded):
    recorded(_two_steps())
    got = _values()
    assert got['loss_stream_ms'] == pytest.approx(42.0)
    assert got['bwd_stream_ms'] == pytest.approx(114.0)
    least = max(work.lbs_points_bwd(SHAPES)[0] / 67e12, work.lbs_points_bwd(SHAPES)[1] / 3.35e12)
    assert got['k10_roofline'] == pytest.approx(100.0 * least / (K10_US_PER_STEP / 1e6))
    assert got['grad_call_mfu'] == pytest.approx(100.0 * 3.0e12 / (0.2 * 67e12))


def test_readers_without_spans(recorded, monkeypatch):
    recorded([])
    assert set(_values()) == {'grad_call_mfu'}
    # Spans without stream times (no CUDA events): K10's share still reads.
    recorded([dict(r, stream_ms=None) for r in _two_steps()])
    assert set(_values()) == {'grad_call_mfu', 'k10_roofline'}
    # Spans of another entry (a fit) count no refiner step.
    recorded([_rec(0, 'fit', None, 0, 90.0), _rec(1, 'fit.solve', 0, 0, 30.0)])
    assert set(_values()) == {'grad_call_mfu'}
    # The program before the spans.
    monkeypatch.delattr(profiling, 'spans')
    assert set(_values()) == {'grad_call_mfu'}
