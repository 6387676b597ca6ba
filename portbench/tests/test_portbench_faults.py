"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU (the harness's look for a card
skipped; the port runs its kernels' plain twins) at 8 bodies, every row
checked, with the cell's own limits, once sound and once for each fault a
one-card cell can have: a step that returns its state unchanged; half of
the batch left out, its rows given the mean over the rest; an answer
altered where it is produced (one body given another's result). No cell
exchanges anything between cards, so that fault has no place here.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

from conftest import small_cell

FIT_CELLS = ['smpl-fit-bulk']


def _run(workload):
    spec = small_cell(workload)
    return harness.run(spec, 2 ** 31 + 11, 0.05, False, 'cpu', time.perf_counter(),
                       log=lambda msg: None)


def _half_mean(out):
    """Rows of the second half replaced by the mean of the first half's."""
    out = dict(out)
    for k, v in out.items():
        if isinstance(v, torch.Tensor) and v.shape[:1] == next(iter(out.values())).shape[:1]:
            h = v.shape[0] // 2
            v = v.clone()
            v[h:] = v[:h].mean(dim=0, keepdim=True)
            out[k] = v
    return out


def _swap_first(out):
    """Body 0 given body 1's result."""
    out = dict(out)
    for k, v in out.items():
        if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] > 1:
            v = v.clone()
            v[0] = v[1]
            out[k] = v
    return out


@pytest.mark.parametrize('workload', FIT_CELLS + ['smpl-forward-bulk'])
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res['correct']
    # attempted / failed count sampled rows: 2 sets of 8, none over a limit.
    assert (res['attempted'], res['failed']) == (16, 0)


@pytest.mark.parametrize('workload', FIT_CELLS)
@pytest.mark.parametrize('fault', ['final_adjustment_unchanged', 'refit_unchanged',
                                   'half_batch', 'answer_altered'])
def test_fit_fault_is_caught(workload, fault, monkeypatch):
    from smplfitter_tpu_torch.models import bodyfitter

    if fault == 'final_adjustment_unchanged':
        # The final adjustment returns the rotations it was given.
        monkeypatch.setattr(bodyfitter, 'fit_global_rotations_dependent_lm',
                            lambda bm, plan, tgt, tj, ref, rj, glob9_prev, *a, **k: glob9_prev)
    elif fault == 'refit_unchanged':
        # The rotation refits of the iterations return no change.
        orig = bodyfitter.fit_global_rotations_lm

        def refit(bm, plan, tgt_vm, tj_lm, reference_vm, rj_lm, reference_spec=None, **kw):
            R = orig(bm, plan, tgt_vm, tj_lm, reference_vm, rj_lm, reference_spec=reference_spec,
                     **kw)
            if reference_spec is None:
                return R
            return torch.eye(3).reshape(9, 1, 1).expand_as(R).contiguous()

        monkeypatch.setattr(bodyfitter, 'fit_global_rotations_lm', refit)
    else:
        orig_fit = bodyfitter.BodyFitter.fit
        change = _half_mean if fault == 'half_batch' else _swap_first
        monkeypatch.setattr(bodyfitter.BodyFitter, 'fit',
                            lambda self, *a, **k: change(orig_fit(self, *a, **k)))
    res = _run(workload)
    assert not res['correct'] and 1 <= res['failed'] <= res['attempted']


@pytest.mark.parametrize('fault', ['fk_unchanged', 'half_batch', 'answer_altered'])
def test_forward_fault_is_caught(fault, monkeypatch):
    from smplfitter_tpu_torch.models import bodymodel

    if fault == 'fk_unchanged':
        # Forward kinematics returns the parent-relative rotations unchanged.
        monkeypatch.setattr(bodymodel, 'fk_rotations', lambda parents, rel: rel)
    else:
        orig = bodymodel.BodyModel.forward
        change = _half_mean if fault == 'half_batch' else _swap_first
        monkeypatch.setattr(bodymodel.BodyModel, 'forward',
                            lambda self, *a, **k: change(orig(self, *a, **k)))
    res = _run('smpl-forward-bulk')
    assert not res['correct'] and 1 <= res['failed'] <= res['attempted']
