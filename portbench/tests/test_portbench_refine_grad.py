"""The ``refine_grad`` entry (cell ``smplx-refine-grad``) under its check.

On the CPU, a whole run at 8 bodies with every row checked (the port runs
its kernels' plain twins) is correct, and comes out not correct with the
timed path broken underneath: K10 dropped (the mesh's cotangent reaches no
parameter), half of the batch given the mean of the other half's
gradients, one body given another's. On the card (``-m cuda``), at the
cell's own size, the program's sampled rows pass the limits and the
reference in float32 with TF32 matrix products fails at least one.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

from conftest import ROOT, small_cell

CELL = 'smplx-refine-grad'


def _run():
    return harness.run(small_cell(CELL), 2 ** 31 + 13, 0.05, False, 'cpu', time.perf_counter(),
                       log=lambda msg: None)


def test_sound_run_is_correct():
    res = _run()
    assert res['correct'] and (res['attempted'], res['failed']) == (16, 0)


def _change_grads(change):
    from smplfitter_tpu_torch.models.bodyfitter_opt import BodyFitterOpt

    orig = BodyFitterOpt.loss_and_grad

    def changed(self, *a, **k):
        loss, grads = orig(self, *a, **k)
        return loss, {name: change(g) for name, g in grads.items()}
    return changed


def _half_mean(g):
    g, h = g.clone(), g.shape[0] // 2
    g[h:] = g[:h].mean(dim=0, keepdim=True)
    return g


def _swap_first(g):
    g = g.clone()
    g[0] = g[1]
    return g


@pytest.mark.parametrize('fault', ['k10_dropped', 'half_batch', 'answer_altered'])
def test_fault_is_caught(fault, monkeypatch):
    from smplfitter_tpu_torch.models.bodyfitter_opt import BodyFitterOpt
    from smplfitter_tpu_torch.ops import lbs_kernels

    if fault == 'k10_dropped':
        orig = lbs_kernels.lbs_points_bwd

        def dropped(*a, **k):
            return tuple(torch.zeros_like(t) for t in orig(*a, **k))
        monkeypatch.setattr(lbs_kernels, 'lbs_points_bwd', dropped)
    else:
        change = _half_mean if fault == 'half_batch' else _swap_first
        monkeypatch.setattr(BodyFitterOpt, 'loss_and_grad', _change_grads(change))
    res = _run()
    assert not res['correct'] and 1 <= res['failed'] <= res['attempted']


@pytest.mark.cuda
def test_control_fails_where_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: TF32 exists only on the card')
    spec = harness.load_cell(ROOT, CELL)
    ctx, program, _ = harness.prepare(spec, 'cuda')
    seed = 2 ** 31 + 103
    sets = harness.draw_inputs(spec, ctx, seed)
    results = [spec.entry.call(program, inp, spec.traffic) for inp in sets]
    samples = harness.sample_rows(spec, results, sets, seed)
    del results, sets, program
    ctx.ref32 = None
    torch.cuda.empty_cache()
    expected = harness.reference_outputs(spec, ctx, samples, torch.float64)
    log = lambda msg: None  # noqa: E731
    _, failed = harness.judge(spec, harness.compare(spec, ctx, [o for o, _ in samples], expected),
                              log)
    assert failed == 0
    control = harness.reference_outputs(spec, ctx, samples, torch.float32, tf32=True)
    control = [{k: torch.cat([b[k] for b in blocks]) for k in blocks[0]} for blocks in control]
    _, failed = harness.judge(spec, harness.compare(spec, ctx, control, expected), log)
    assert failed >= 1
