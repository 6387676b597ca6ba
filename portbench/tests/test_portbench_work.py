"""The work counts of ``work/`` against the port's smoke-test yardstick
(``chip_smoke.kernel_work``) on the operands the port's fit and forward pass
hand their kernels, recorded on the CPU at B=32. The counts here are taken
from the cell's shapes with the true vertex count, where the kernels' operands
are padded to a multiple of 256 rows: they agree within 1%."""

from __future__ import annotations

import os
import sys

import pytest
import torch

from portbench import harness
from portbench.reference import RefModel

from conftest import ROOT, any_cell

B = 32
# kernel_work key -> the stage of work/fit.py it counts
STAGE = {'rhs_moments_h': 'rhs_moments', 'rhs_moments_cached': 'rhs_moments',
         'gram_assembly': 'gram', 'term1': 'term1', 'posed_template': 'posed_template',
         'wgram': 'wgram', 'recon_part_sums_cached': 'recon_part_sums',
         'part_sums': 'part_sums', 'lbs_points': 'lbs_points'}
WRAPPER_KEY = {'rhs_moments_h': 'rhs_moments_h', 'rhs_moments_cached': 'rhs_moments_cached',
               'gram_assembly': 'gram_assembly', 'term1': 'term1',
               'posed_template_lm': 'posed_template', 'wgram_moments': 'wgram',
               'recon_part_sums_cached_lm': 'recon_part_sums_cached',
               'part_sums_vm_lm': 'part_sums', 'lbs_points': 'lbs_points'}


def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def _recorded_work(run, skip=()):
    """{stage: [flops, bytes]} summed over the kernel calls ``run`` makes."""
    from smplfitter_tpu_torch.ops import lbs_kernels

    smoke = _smoke()
    calls = smoke.record_calls(lbs_kernels, list(WRAPPER_KEY), run)
    totals = {}
    for wrapper, recorded in calls.items():
        key = WRAPPER_KEY[wrapper]
        if key in skip:
            continue
        for args, kwargs in recorded:
            k = key + ('_w' if kwargs.get('omega') is not None else '')
            f, b = smoke.kernel_work(k, args, kwargs)
            t = totals.setdefault(STAGE[key], [0.0, 0.0])
            t[0] += f
            t[1] += b
    return totals


def _counted(stages):
    totals = {}
    for name, f, b in stages:
        t = totals.setdefault(name, [0.0, 0.0])
        t[0] += f
        t[1] += b
    return totals


def _agree(counted, recorded):
    assert set(counted) == set(recorded)
    for name in counted:
        for c, r in zip(counted[name], recorded[name]):
            assert abs(c - r) <= 0.01 * r, (name, c, r)


@pytest.mark.parametrize('workload', ['smpl-fit-bulk', 'smplx-fit-bulk', 'smplx-wfit-bulk'])
def test_fit_work_matches_kernel_work(workload, model_roots):
    from smplfitter_tpu_torch.models.bodyfitter import BodyFitter
    from smplfitter_tpu_torch.models.bodymodel import BodyModel
    from smplfitter_tpu_torch.ops import lbs_kernels

    spec = any_cell(workload)
    cfg, tr = spec.config, dict(spec.traffic, batch=B)
    ref = RefModel(model_roots[cfg['name']], cfg['model'], cfg['num_betas'], 'cpu',
                   torch.float32)
    bm = BodyModel(cfg['model'], 'neutral', model_root=model_roots[cfg['name']],
                   num_betas=cfg['num_betas'], device='cpu')
    fitter = BodyFitter(bm, num_betas=cfg['num_betas'])
    gen = torch.Generator().manual_seed(0)
    from types import SimpleNamespace

    ctx = SimpleNamespace(config=cfg, traffic=dict(tr, target_sets=1),
                          device='cpu')
    inp = spec.entry.make_inputs(ctx, ref, gen)[0]
    recorded = _recorded_work(lambda: spec.entry.call(fitter, inp, tr),
                              skip=('gram_assembly',) if cfg['model'] == 'smplx' else ())
    if not tr.get('weights'):
        # The first orientation fit's part sums against the T-pose are one
        # tensor product, no kernel: the count is the per-part kernel's.
        plan = fitter.plan
        t = lbs_kernels.to_vertex_major(inp['target_vertices'])
        f, b = _smoke().kernel_work('part_sums', (t, plan.default_mesh_vm, plan.parts))
        recorded['part_sums'] = [f, b]
    _agree(_counted(spec.work.stages(harness.shapes(ref, tr))), recorded)


def test_forward_work_matches_kernel_work(model_roots):
    from smplfitter_tpu_torch.models.bodymodel import BodyModel

    spec = harness.load_cell(ROOT, 'smpl-forward-bulk')
    cfg, tr = spec.config, dict(spec.traffic, batch=B)
    bm = BodyModel(cfg['model'], 'neutral', model_root=model_roots['smpl'],
                   num_betas=cfg['num_betas'], device='cpu')
    from types import SimpleNamespace

    from portbench.params import draw_params

    ctx = SimpleNamespace(config=cfg, device='cpu')
    pose, betas, trans = draw_params(ctx, torch.Generator().manual_seed(0), B)
    recorded = _recorded_work(lambda: bm(pose_rotvecs=pose, shape_betas=betas, trans=trans))
    ref = RefModel(model_roots['smpl'], 'smpl', cfg['num_betas'], 'cpu', torch.float32)
    _agree(_counted(spec.work.stages(harness.shapes(ref, tr))), recorded)
