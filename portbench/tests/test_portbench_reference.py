"""The plain reference against the port's CPU path (the kernels' plain twins)
at B=32, on the SMPL and SMPL-X configurations' synthetic models: the forward
pass, and the headline fit with and without per-call weights. The tests are
the only place that imports both."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.reference import RefModel, closest_rotation, log_rotation, rodrigues

B = 32


def _inputs(cfg, weighted, seed=0):
    from types import SimpleNamespace

    from portbench.params import draw_params

    gen = torch.Generator().manual_seed(seed)
    ctx = SimpleNamespace(config=cfg, device='cpu')
    pose, betas, trans = draw_params(ctx, gen, B)
    ws = None
    if weighted:
        ws = (torch.rand((B, cfg['num_vertices']), generator=gen) * 1.9 + 0.1,
              torch.rand((B, cfg['num_joints']), generator=gen) * 1.9 + 0.1)
    return pose, betas, trans, ws


def _config(name):
    return harness.read_json(f'{harness.PB_DIR}/configs/{name}.json')


@pytest.mark.parametrize('name', ['smpl', 'smplx'])
def test_forward_matches_port(name, model_roots):
    from smplfitter_tpu_torch.models.bodymodel import BodyModel

    cfg = _config(name)
    pose, betas, trans, _ = _inputs(cfg, False)
    ref = RefModel(model_roots[name], cfg['model'], cfg['num_betas'], 'cpu', torch.float64)
    verts, joints = ref.forward(pose.double(), betas.double(), trans.double())
    bm = BodyModel(cfg['model'], 'neutral', model_root=model_roots[name],
                   num_betas=cfg['num_betas'], device='cpu')
    out = bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    # float32 rounding of coordinates of about a metre
    assert (out['vertices'].double() - verts).abs().max() < 2e-6
    assert (out['joints'].double() - joints).abs().max() < 2e-6


# Largest gaps over 32 bodies of the port's float32 fit from the float64
# reference; SMPL-X's hands amplify float32 rounding (see PERF.md).
FIT_TOL = {'smpl': dict(betas_gap=2e-4, trans_gap_mm=0.02, pose_gap_mrad=0.5, mesh_gap_um=20.0),
           'smplx': dict(betas_gap=1e-2, trans_gap_mm=1.0, pose_gap_mrad=50.0, mesh_gap_um=2000.0)}


@pytest.mark.parametrize('name,weighted', [('smpl', False), ('smplx', False),
                                           ('smplx', True)])
def test_fit_matches_port(name, weighted, model_roots):
    from smplfitter_tpu_torch.models.bodyfitter import BodyFitter
    from smplfitter_tpu_torch.models.bodymodel import BodyModel

    from portbench.entries import fit as entry

    cfg = _config(name)
    pose, betas, trans, ws = _inputs(cfg, weighted, seed=1)
    ref = RefModel(model_roots[name], cfg['model'], cfg['num_betas'], 'cpu', torch.float64)
    tv, tj = ref.forward(pose.double(), betas.double(), trans.double())
    inp = dict(target_vertices=tv.float(), target_joints=tj.float())
    if weighted:
        inp.update(vertex_weights=ws[0], joint_weights=ws[1])
    traffic = harness.read_json(f'{harness.PB_DIR}/traffic/fit-b131072.json')
    bm = BodyModel(cfg['model'], 'neutral', model_root=model_roots[name],
                   num_betas=cfg['num_betas'], device='cpu')
    out = entry.call(BodyFitter(bm, num_betas=cfg['num_betas']), inp, traffic)
    gaps = entry.gaps(out, entry.reference(ref, inp, traffic), ref)
    for key, tol in FIT_TOL[name].items():
        assert float(gaps[key].max()) < tol, (key, float(gaps[key].max()))


def test_shape_solve_is_least_squares(model_roots):
    """For fixed orientations the reference's betas and translation minimise
    the regularised squared distances: every small step away raises them."""
    cfg = _config('smpl')
    pose, betas, trans, _ = _inputs(cfg, False, seed=2)
    ref = RefModel(model_roots['smpl'], 'smpl', cfg['num_betas'], 'cpu', torch.float64)
    tv, tj = ref.forward(pose.double(), betas.double(), trans.double())
    tv = tv + 0.01 * torch.randn(tv.shape, generator=torch.Generator().manual_seed(4),
                                 dtype=torch.float64)
    glob = ref.fk_rotations(rodrigues(0.9 * pose.double().reshape(B, -1, 3)))
    l2 = torch.ones(cfg['num_betas'], dtype=torch.float64)
    l2[:2] = 0.0
    b0, t0, _, _ = ref.solve_shape(glob, tv, tj, None, l2)

    def cost(b, t):
        mesh0, jac, p, P = ref.mesh_and_jacobian(glob)
        v = mesh0 + torch.einsum('bvce,be->bvc', jac, b) + t[:, None]
        j = p + torch.einsum('bjce,be->bjc', P, b) + t[:, None]
        return (((v - tv) ** 2).sum((1, 2)) + ((j - tj) ** 2).sum((1, 2))
                + (l2 * b ** 2).sum(1))

    c0 = cost(b0, t0)
    gen = torch.Generator().manual_seed(5)
    for _ in range(4):
        db = 1e-3 * torch.randn(b0.shape, generator=gen, dtype=torch.float64)
        dt = 1e-4 * torch.randn(t0.shape, generator=gen, dtype=torch.float64)
        assert (cost(b0 + db, t0 + dt) > c0).all()


def test_rotation_helpers():
    gen = torch.Generator().manual_seed(3)
    rv = torch.randn((64, 3), generator=gen, dtype=torch.float64)
    rv = rv / rv.norm(dim=-1, keepdim=True) * torch.rand((64, 1), generator=gen,
                                                         dtype=torch.float64) * 3.0
    R = rodrigues(rv)
    assert torch.allclose(R @ R.transpose(-1, -2), torch.eye(3, dtype=torch.float64), atol=1e-12)
    assert torch.allclose(log_rotation(R), rv, atol=1e-9)
    noisy = R + 1e-3 * torch.randn((64, 3, 3), generator=gen, dtype=torch.float64)
    P = closest_rotation(noisy)
    assert torch.allclose(torch.linalg.det(P), torch.ones(64, dtype=torch.float64))
    assert (P - R).abs().max() < 5e-3
