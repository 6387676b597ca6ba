"""The forward entry: ``BodyModel.forward(pose_rotvecs, shape_betas, trans)``
of the port, to vertices and joints.

Inputs per parameter set, drawn on the device from the run's generator as
the fit's are: pose rotation vectors N(0, pose_std) (B, 3J), betas N(0, 1)
(B, E), translations N(0, 0.5) (B, 3). The check poses the sampled rows of
the last call on each set again with the plain reference and compares the
vertices and joints that the timed call returned.
"""

from __future__ import annotations

from portbench.params import draw_params

OUTPUTS = ('vertices', 'joints')
TRAFFIC_KEYS = ()


def setup(ctx):
    from smplfitter_tpu_torch.models.bodymodel import BodyModel

    cfg = ctx.config
    return BodyModel(cfg['model'], cfg['gender'], model_root=ctx.model_root,
                     num_betas=cfg['num_betas'], device=ctx.device)


def make_inputs(ctx, ref, gen):
    sets = []
    for _ in range(ctx.traffic['target_sets']):
        pose, betas, trans = draw_params(ctx, gen, ctx.traffic['batch'])
        sets.append(dict(pose_rotvecs=pose, shape_betas=betas, trans=trans))
    return sets


def call(program, inp, traffic):
    return program(**inp)


def rows_of(result, inp, rows):
    out = {k: result[k][rows].clone() for k in OUTPUTS}
    return out, {k: v[rows].clone() for k, v in inp.items()}


def reference(ref, inp, traffic):
    """The plain reference's vertices and joints of the same parameters."""
    dt = ref.dtype
    verts, joints = ref.forward(inp['pose_rotvecs'].to(dt), inp['shape_betas'].to(dt),
                                inp['trans'].to(dt))
    return dict(vertices=verts, joints=joints)


def gaps(out, expected, ref):
    """Per row, the largest gap (micrometres) of the vertices and joints of
    ``out`` from ``expected``, in ``ref``'s dtype."""
    dt = ref.dtype
    return {name: (out[k].to(dt) - expected[k]).abs().flatten(1).amax(dim=1) * 1e6
            for k, name in (('vertices', 'vertex_gap_um'), ('joints', 'joint_gap_um'))}
