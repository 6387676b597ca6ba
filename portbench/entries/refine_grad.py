"""The refiner-step entry: ``BodyFitterOpt.loss_and_grad`` of the port, the
value and gradient of the refiner's loss (``refine``: the call's keywords)
with respect to global 6D rotations, betas and translations.

Inputs per target set, drawn on the device from the run's generator in this
order: pose rotation vectors N(0, pose_std) (B, 3J), betas N(0, 1) (B, E),
translations N(0, 0.5) (B, 3), whose forward pass by the benchmark is the
targets (vertices and joints) as in ``entries/fit.py``; then the starting
point's offsets from those draws (``start_noise``): N(0, pose) on each
rotation-vector component, N(0, betas) on each beta, N(0, trans) metres on
each translation. The benchmark turns the starting rotation vectors into
global rotations and their 6D form.

The check takes the gradients again at the sampled rows of the last call on
each target set with the plain reference (``reference_refine.py``) and
compares, per row, each gradient's largest gap relative to that row's
largest reference component.
"""

from __future__ import annotations

import torch

from portbench import refine_spans
from portbench.entries.fit import FORWARD_BLOCK
from portbench.params import draw_params
from portbench.reference import rodrigues
from portbench.reference_refine import PARAMS, refine_grads, rotmat_to_rot6d

TRAFFIC_KEYS = ('start_noise', 'refine')
OUTPUTS = tuple('grad_' + k for k in PARAMS)


def setup(ctx):
    from smplfitter_tpu_torch.models.bodyfitter_opt import BodyFitterOpt
    from smplfitter_tpu_torch.models.bodymodel import BodyModel

    if not hasattr(BodyFitterOpt, 'loss_and_grad'):
        raise SystemExit('refine_grad: this program has no BodyFitterOpt.loss_and_grad')
    cfg = ctx.config
    bm = BodyModel(cfg['model'], cfg['gender'], model_root=ctx.model_root,
                   num_betas=cfg['num_betas'], device=ctx.device)
    return BodyFitterOpt(bm)


def make_inputs(ctx, ref, gen):
    """The traffic's target sets with their starting points, on the device."""
    from portbench.harness import shapes

    refine_spans.cell_shapes.update(shapes(ref, ctx.traffic))
    tr, B, dev = ctx.traffic, ctx.traffic['batch'], ctx.device
    noise = tr['start_noise']
    sets = []
    for _ in range(tr['target_sets']):
        pose, betas, trans = draw_params(ctx, gen, B)
        tv = torch.empty((B, ref.V, 3), device=dev)
        tj = torch.empty((B, ref.J, 3), device=dev)
        for s in range(0, B, FORWARD_BLOCK):
            e = s + FORWARD_BLOCK
            tv[s:e], tj[s:e] = ref.forward(pose[s:e], betas[s:e], trans[s:e])
        pose = pose + torch.randn(pose.shape, generator=gen, device=dev) * noise['pose']
        betas = betas + torch.randn(betas.shape, generator=gen, device=dev) * noise['betas']
        trans = trans + torch.randn(trans.shape, generator=gen, device=dev) * noise['trans']
        glob = ref.fk_rotations(rodrigues(pose.reshape(B, ref.J, 3)))
        sets.append(dict(target_vertices=tv, target_joints=tj, rot6d=rotmat_to_rot6d(glob),
                         betas=betas, trans=trans))
    return sets


def call(program, inp, traffic):
    _, grads = program.loss_and_grad({k: inp[k] for k in PARAMS}, inp['target_vertices'],
                                     inp['target_joints'], **traffic['refine'])
    return {'grad_' + k: g for k, g in grads.items()}


def rows_of(result, inp, rows):
    """The sampled rows of a call's gradients and of its inputs, copied."""
    out = {k: result[k][rows].clone() for k in OUTPUTS}
    return out, {k: v[rows].clone() for k, v in inp.items()}


def reference(ref, inp, traffic):
    """The plain reference's gradients at the same rows, of the whole
    batch's loss (``ref``: a RefModel)."""
    dt = ref.dtype
    grads = refine_grads(ref, {k: inp[k].to(dt) for k in PARAMS}, inp['target_vertices'],
                         inp['target_joints'], traffic['batch'], **traffic['refine'])
    return {'grad_' + k: g for k, g in grads.items()}


def gaps(out, expected, ref):
    """Per row, the largest gap of each gradient of ``out`` from
    ``expected`` over the largest component of ``expected`` in that row, in
    ``ref``'s dtype."""
    dt = ref.dtype
    g = {}
    for k in OUTPUTS:
        want = expected[k].flatten(1)
        g[k + '_gap'] = ((out[k].to(dt).flatten(1) - want).abs().amax(dim=1)
                         / want.abs().amax(dim=1))
    return g
