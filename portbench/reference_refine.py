"""Plain PyTorch reference of the refiner's loss and its gradient, on top of
``reference.py``'s ``RefModel`` and independent of the program under test.

The refiner optimises global joint rotations in the 6D representation of
Zhou et al., CVPR 2019 (the first two columns of each rotation matrix;
Gram-Schmidt turns them back into a rotation), the betas and the
translation. Its loss, for a batch of N bodies, is the mean over the batch
and the vertices of the distance of each posed vertex to its target, plus
the same mean over the joints, plus ``beta_regularizer`` times the mean
square of the betas from the third on.

A row's gradient depends on that row's terms alone, so the reference takes
the gradient of a sample of rows from their terms divided by the full
batch's counts (N V, N J and N (E - 2)): the gradient the whole batch's
loss has at those rows. Gradients come from autograd at the model's dtype
(float64 for the check; float32 with TF32 for its control).
"""

from __future__ import annotations

import torch

PARAMS = ('rot6d', 'betas', 'trans')


def rot6d_to_rotmat(rot6d):
    """(..., 6) -> (..., 3, 3): the two 3-vectors, made orthonormal by
    Gram-Schmidt, are the first two columns; their cross product the third."""
    a1, a2 = rot6d[..., :3], rot6d[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def rotmat_to_rot6d(rotmat):
    """(..., 3, 3) -> (..., 6): the first two columns."""
    return torch.cat([rotmat[..., :, 0], rotmat[..., :, 1]], dim=-1)


def forward_global(ref, glob, betas, trans):
    """Vertices (B, V, 3) and joints (B, J, 3) of ``ref`` (a RefModel) posed
    by global rotations ``glob`` (B, J, 3, 3), as ``RefModel.forward`` poses
    them from relative ones."""
    rot_blend, v_posed, _, _ = ref.posed_parts(glob)
    rest = ref.j_template + torch.einsum('jce,be->bjc', ref.j_shapedirs, betas)
    joints = ref.fk_positions(glob, rest)
    t = joints - torch.einsum('bjcd,bjd->bjc', glob, rest)
    shaped = v_posed + torch.einsum('vce,be->bvc', ref.shapedirs, betas)
    verts = (torch.einsum('bvcd,bvd->bvc', rot_blend, shaped)
             + torch.einsum('vj,bjc->bvc', ref.weights, t))
    return verts + trans[:, None], joints + trans[:, None]


def refine_loss(ref, params, target_vertices, target_joints, batch: int,
                beta_regularizer: float):
    """The rows' share of the loss of a batch of ``batch`` bodies (``params``:
    'rot6d' (n, J, 6), 'betas' (n, E), 'trans' (n, 3), at ``ref``'s dtype)."""
    verts, joints = forward_global(ref, rot6d_to_rotmat(params['rot6d']), params['betas'],
                                   params['trans'])
    loss = torch.linalg.vector_norm(verts - target_vertices, dim=-1).sum() / (batch * ref.V)
    if target_joints is not None:
        loss = loss + (torch.linalg.vector_norm(joints - target_joints, dim=-1).sum()
                       / (batch * ref.J))
    E = params['betas'].shape[1]
    if beta_regularizer > 0 and E > 2:
        loss = loss + beta_regularizer * (params['betas'][:, 2:] ** 2).sum() / (batch * (E - 2))
    return loss


def refine_grads(ref, params, target_vertices, target_joints, batch: int,
                 beta_regularizer: float) -> dict:
    """{name: gradient} of the batch's loss at the rows of ``params``, by
    autograd at ``ref``'s dtype."""
    dt = ref.dtype
    leaves = {k: params[k].detach().to(dt).requires_grad_() for k in PARAMS}
    tj = None if target_joints is None else target_joints.to(dt)
    with torch.enable_grad():
        loss = refine_loss(ref, leaves, target_vertices.to(dt), tj, batch, beta_regularizer)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(PARAMS, grads))
