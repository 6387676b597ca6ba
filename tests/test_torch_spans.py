"""Stage spans of the port's fit and forward pass (``utils/profiling.span``) on
the CPU: nothing recorded without the profiler; under it the headline fit's
stages in order and one span per forward pass; each span's marks bracket the
operators run inside it and are the only events that carry its name; the
counter changes a span records; the bounded buffer; ``trace()``'s
``spans.json``."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smplfitter_tpu_torch import BodyFitter, BodyModel
from smplfitter_tpu_torch.ops import lbs_kernels
from smplfitter_tpu_torch.utils import profiling, synthetic

FIT_KW = dict(num_iter=3, beta_regularizer=1.0, final_adjust_rots=True,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
FIT_STAGES = ['fit', 'fit.prepare', 'fit.rotations', 'fit.solve', 'fit.rotations', 'fit.solve',
              'fit.rotations', 'fit.solve', 'fit.adjust', 'fit.outputs']
# Wrappers the headline fit calls, each moving one counter per call here
# (rhs_moments_h also K2_PIPELINE's overlapped loop, as on long runs).
COUNTED = {'rhs_moments_h': ('LAUNCHES', 'K2_PIPELINE'), 'gram_assembly': ('TORCH_VJPS',),
           'recon_part_sums_cached_lm': ('HOST_COVERS',)}
KEYS = {'LAUNCHES': 'launches', 'TORCH_VJPS': 'torch_vjps', 'HOST_COVERS': 'host_covers',
        'K2_PIPELINE': 'k2_overlapped'}


@pytest.fixture(scope='module')
def smpl(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('body_models'))
    synthetic.write_model_files(d, 'smpl', 500)
    bm = BodyModel('smpl', 'neutral', model_root=d + '/smpl', device='cpu')
    rng = np.random.default_rng(5)
    pose = torch.tensor(rng.normal(0, 0.3, (32, 72)), dtype=torch.float32)
    betas = torch.tensor(rng.normal(0, 1, (32, 10)), dtype=torch.float32)
    out = bm(pose, betas)
    return bm, BodyFitter(bm), out['vertices'], out['joints'], pose


def _fit_and_forward(smpl):
    bm, fitter, verts, joints, pose = smpl
    fitter.fit(verts, joints, **FIT_KW)
    bm(pose[:4])


@pytest.fixture(scope='module')
def profiled(smpl):
    """The spans and the profiler's top-level host events of one headline
    fit (B=32) and one forward pass, with the counted wrappers moving their
    counters: (spans by ordinal, events, [(ns, counter) of each count])."""
    counted = []
    originals = {name: getattr(lbs_kernels, name) for name in COUNTED}
    saved = {c: dict(getattr(lbs_kernels, c)) for c in KEYS}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            for counter in COUNTED[name]:
                getattr(lbs_kernels, counter)[next(iter(saved[counter]))] += 1
                counted.append((time.perf_counter_ns(), counter))
            return fn(*args, **kwargs)
        return wrapped

    profiling.clear_spans()
    try:
        for name, fn in originals.items():
            setattr(lbs_kernels, name, counting(name, fn))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fit_and_forward(smpl)
    finally:
        for name, fn in originals.items():
            setattr(lbs_kernels, name, fn)
        for c, values in saved.items():
            getattr(lbs_kernels, c).update(values)
    recs = sorted(profiling.spans(), key=lambda r: r['index'])
    profiling.clear_spans()
    events = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
              if e.cpu_parent is None]
    return recs, events, counted


def test_without_the_profiler_nothing_records(smpl):
    profiling.clear_spans()
    _fit_and_forward(smpl)
    assert profiling.spans() == []
    assert not isinstance(profiling.span('fit'), profiling._Span)


def test_the_fit_records_its_stages_in_order(profiled):
    recs = profiled[0]
    assert [r['name'] for r in recs] == FIT_STAGES + ['forward']
    fit, forward = recs[0], recs[-1]
    assert fit['parent'] is None and forward['parent'] is None
    assert all(r['parent'] == r['call'] == fit['index'] for r in recs[1:-1])
    assert forward['call'] == forward['index']
    for r in recs:
        assert r['host_start_ns'] <= r['host_end_ns'] and r['stream_ms'] is None


def _intervals(recs, events):
    at = {name: (s, e) for s, e, name in events}
    return [(at[r['marks'][0]][0], at[r['marks'][1]][1]) for r in recs]


def test_each_span_brackets_the_operators_run_inside_it(profiled):
    recs, events, _ = profiled
    spans = _intervals(recs, events)
    marks = {m for r in recs for m in r['marks']}
    ops = [(s, e) for s, e, name in events if name not in marks]
    (fit_s, fit_e), stages = spans[0], spans[1:-1]
    # The stages follow one another inside the fit.
    assert fit_s <= stages[0][0] and stages[-1][1] <= fit_e
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))
    for lo, hi in spans:
        inside = [(s, e) for s, e in ops if lo <= s <= hi]
        assert inside, 'every span runs some operator'
        assert all(e <= hi for _, e in inside), 'an operator leaves the span it began in'
    # Every operator the fit runs lies in one of its stages but the fit's own
    # input conversions, which run before its first stage.
    for s, e in ops:
        if stages[0][0] <= s <= fit_e:
            assert any(lo <= s and e <= hi for lo, hi in stages)


def test_only_the_marks_carry_a_span_name(profiled):
    recs, events, _ = profiled
    marks = {m for r in recs for m in r['marks']}
    names = {r['name'] for r in recs}
    assert len(marks) == 2 * len(recs)
    for _, _, name in events:
        assert name not in names
        if name.split('#')[0] in names:
            assert name in marks
    assert marks <= {name for _, _, name in events}


def test_the_counter_changes_are_those_made_inside_each_span(profiled):
    recs, _, counted = profiled
    for r in recs:
        made = {k: 0 for k in KEYS.values()}
        for ns, counter in counted:
            if r['host_start_ns'] <= ns <= r['host_end_ns']:
                made[KEYS[counter]] += 1
        assert {k: r[k] for k in made} == made, r['name']
    fit, stages = recs[0], recs[1:-1]
    assert fit['launches'] > 0 and fit['torch_vjps'] > 0 and fit['host_covers'] > 0
    assert fit['k2_overlapped'] == 3  # one K2 launch per shape solve
    for k in KEYS.values():
        assert fit[k] == sum(r[k] for r in stages)


def test_the_buffer_stays_bounded():
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(profiling.SPAN_LIMIT + 10):
            with profiling.span('fit'):
                pass
    recs = profiling.spans()
    profiling.clear_spans()
    assert len(recs) == profiling.SPAN_LIMIT
    assert recs[-1]['index'] - recs[0]['index'] == profiling.SPAN_LIMIT - 1


def test_trace_writes_the_spans_beside_the_trace(tmp_path, smpl):
    bm, pose = smpl[0], smpl[4]
    with profiling.span('forward'):
        pass  # outside any profiler: not recorded
    with profiling.trace(str(tmp_path)) as logdir:
        bm(pose[:2])
    with open(os.path.join(logdir, 'spans.json')) as f:
        recs = json.load(f)
    assert [r['name'] for r in recs] == ['forward']
    with open(os.path.join(logdir, 'trace.json')) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert set(recs[0]['marks']) <= names
