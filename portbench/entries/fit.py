"""The fit entry: ``BodyFitter.fit`` of the port, in the configuration its
traffic file names (``fit``: the call's keywords; ``weights``: per-call
vertex and joint weights drawn uniform in [low, high), or null).

Inputs per target set, drawn on the device from the run's generator in this
order: pose rotation vectors N(0, pose_std) (B, 3J), betas N(0, 1) (B, E),
translations N(0, 0.5) (B, 3), then the weights (B, V) and (B, J); the
targets are the benchmark's own forward pass of those parameters.

The check fits the sampled rows of the last call on each target set again
with the plain reference and compares the betas, translations and pose
rotation vectors that the timed call returned.
"""

from __future__ import annotations

import torch

from portbench.params import draw_params
from portbench.reference import log_rotation, rodrigues

OUTPUTS = ('shape_betas', 'trans', 'pose_rotvecs')
TRAFFIC_KEYS = ('fit', 'weights')
# Bodies per block of the benchmark's own forward pass that makes the targets.
FORWARD_BLOCK = 4096


def setup(ctx):
    from smplfitter_tpu_torch.models.bodyfitter import BodyFitter
    from smplfitter_tpu_torch.models.bodymodel import BodyModel

    cfg = ctx.config
    bm = BodyModel(cfg['model'], cfg['gender'], model_root=ctx.model_root,
                   num_betas=cfg['num_betas'], device=ctx.device)
    return BodyFitter(bm, num_betas=cfg['num_betas'])


def make_inputs(ctx, ref, gen):
    """The traffic's target sets: dicts of targets (and weights) on the device."""
    tr, B = ctx.traffic, ctx.traffic['batch']
    sets = []
    for _ in range(tr['target_sets']):
        pose, betas, trans = draw_params(ctx, gen, B)
        tv = torch.empty((B, ref.V, 3), device=ctx.device)
        tj = torch.empty((B, ref.J, 3), device=ctx.device)
        step = FORWARD_BLOCK
        for s in range(0, B, step):
            tv[s:s + step], tj[s:s + step] = ref.forward(pose[s:s + step], betas[s:s + step],
                                                        trans[s:s + step])
        inp = dict(target_vertices=tv, target_joints=tj)
        w = tr.get('weights')
        if w:
            span = w['high'] - w['low']
            inp['vertex_weights'] = (torch.rand((B, ref.V), generator=gen, device=ctx.device)
                                     * span + w['low'])
            inp['joint_weights'] = (torch.rand((B, ref.J), generator=gen, device=ctx.device)
                                    * span + w['low'])
        sets.append(inp)
    return sets


def call(program, inp, traffic):
    return program.fit(**inp, **traffic['fit'])


def rows_of(result, inp, rows):
    """The sampled rows of a call's outputs and of its inputs, copied."""
    out = {k: result[k][rows].clone() for k in OUTPUTS}
    return out, {k: v[rows].clone() for k, v in inp.items()}


def reference(ref, inp, traffic):
    """The plain reference's fit of the same inputs (``ref``: a RefModel)."""
    fit = traffic['fit']
    dt = ref.dtype
    get = lambda k: None if k not in inp else inp[k].to(dt)  # noqa: E731
    return ref.fit(get('target_vertices'), get('target_joints'), get('vertex_weights'),
                   get('joint_weights'), num_iter=fit['num_iter'],
                   beta_regularizer=fit['beta_regularizer'],
                   final_adjust_rots=fit['final_adjust_rots'])


def gaps(out, expected, ref):
    """Per row, the largest gap of the betas, the translation (mm), the joint
    rotations (the angle between the two, mrad) and the fitted mesh (um:
    each result posed by the reference ``ref``) of ``out`` from ``expected``,
    in ``ref``'s dtype. The mesh gap judges a fit by the body it describes:
    it reads no gap along directions the fit cannot see (a shape component
    or a twist that moves no vertex)."""
    dt = ref.dtype
    g = dict(
        betas_gap=(out['shape_betas'].to(dt) - expected['shape_betas']).abs().amax(dim=1),
        trans_gap_mm=(out['trans'].to(dt) - expected['trans']).abs().amax(dim=1) * 1e3)
    # Rotations compare by the angle between them: a rotation vector and its
    # twin of angle 2 pi - a about the opposite axis are the same rotation.
    B, J3 = expected['pose_rotvecs'].shape
    rel = (rodrigues(out['pose_rotvecs'].to(dt).reshape(B, J3 // 3, 3)).transpose(-1, -2)
           @ rodrigues(expected['pose_rotvecs'].reshape(B, J3 // 3, 3)))
    g['pose_gap_mrad'] = torch.linalg.vector_norm(log_rotation(rel), dim=-1).amax(1) * 1e3
    mesh = ref.forward(out['pose_rotvecs'].to(dt), out['shape_betas'].to(dt), out['trans'].to(dt))[0]
    mesh_ref = ref.forward(expected['pose_rotvecs'], expected['shape_betas'], expected['trans'])[0]
    g['mesh_gap_um'] = (mesh - mesh_ref).abs().flatten(1).amax(dim=1) * 1e6
    return g
