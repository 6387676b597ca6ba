"""Gradient refinement of closed-form fits (Adam over global 6D rotations),
ported from ``smplfitter_tpu.models.bodyfitter_opt``.

Initializes with the closed-form :class:`BodyFitter`, then refines pose, shape
and translation (and the kid factor) by Adam on the vertex and joint alignment
loss. As in the JAX package, the optimization runs over GLOBAL rotations in
the 6D representation, so a distal joint's gradient does not pass through the
kinematic chain; the original SMPLFitter library's refiner optimizes relative
rotations instead. The divergence is kept: the port follows the JAX package.

Each step is :meth:`BodyFitterOpt.loss_and_grad`, one forward pass through
``BodyModel.forward(glob_rotmats=...)`` (K1 on the card) and its backward
(K10), then ``torch.optim.Adam`` in a Python loop. The learning-rate schedule
is the JAX package's optax one written out: a linear warmup from 0 to ``lr``
over ``max(1, int(n * warmup_ratio))`` steps, then a cosine decay to 0 over
``max(1, n - warmup)`` steps, evaluated at the step's index before the update
(so the first step runs at lr 0 and only moves Adam's moments).
"""

from __future__ import annotations

import math

import torch

from ..ops import rotation as rot_ops
from ..utils import profiling
from .bodyfitter import BodyFitter
from .bodymodel import BodyModel, fk_rotations, index_tensor

ADAM_BETAS = (0.97, 0.999)
ADAM_EPS = 1e-8


def refine_schedule(num_steps: int, lr: float, warmup_ratio: float):
    """``schedule(k)``: the learning rate of Adam step k = 0 .. num_steps - 1."""
    warmup = max(1, int(num_steps * warmup_ratio))
    decay = max(1, num_steps - warmup)

    def schedule(k: int) -> float:
        if k < warmup:
            return (0.0 - lr) * (1 - k / warmup) + lr
        return lr * 0.5 * (1 + math.cos(math.pi * min(k - warmup, decay) / decay))
    return schedule


class BodyFitterOpt:
    """Closed-form fit + optional Adam refinement, on the model's device."""

    def __init__(self, body_model: BodyModel, enable_kid: bool = False):
        self.body_model = body_model
        self.fitter = BodyFitter(body_model, enable_kid=enable_kid)
        self.enable_kid = enable_kid

    def fit(
        self,
        target_vertices,
        target_joints=None,
        vertex_weights=None,
        joint_weights=None,
        num_iter: int = 1,
        beta_regularizer: float = 1.0,
        beta_regularizer2: float = 0.0,
        share_beta: bool = False,
        final_adjust_rots: bool = True,
        scale_target: bool = False,
        scale_fit: bool = False,
        refine_steps: int = 0,
        refine_lr: float = 0.03,
        warmup_ratio: float = 0.5,
    ) -> dict:
        """Closed-form fit, then ``refine_steps`` Adam steps (0 = no
        refinement, the fit's result as it is). The refined result holds
        pose_rotvecs, shape_betas, trans (and kid_factor)."""
        init = self.fitter.fit(
            target_vertices,
            target_joints=target_joints,
            vertex_weights=vertex_weights,
            joint_weights=joint_weights,
            num_iter=num_iter,
            beta_regularizer=beta_regularizer,
            beta_regularizer2=beta_regularizer2,
            share_beta=share_beta,
            final_adjust_rots=final_adjust_rots if refine_steps == 0 else False,
            scale_target=scale_target,
            scale_fit=scale_fit,
            requested_keys=('pose_rotvecs', 'shape_betas', 'trans'),
        )
        if refine_steps == 0:
            return init
        return self._refine(target_vertices, target_joints, vertex_weights, joint_weights,
                            init['pose_rotvecs'], init['shape_betas'], init['trans'],
                            init.get('kid_factor'), beta_regularizer, refine_steps, refine_lr,
                            warmup_ratio)

    def loss_and_grad(self, params: dict, target_vertices, target_joints=None,
                      vertex_weights=None, joint_weights=None,
                      beta_regularizer: float = 1.0) -> tuple:
        """The refiner's loss at ``params`` and its gradient with respect to
        each of them: one step of :meth:`fit`'s refinement before Adam's
        update, and the loss a training pipeline puts through the model.

        ``params``: ``'rot6d'`` (B, J, 6) global rotations in the 6D
        representation, ``'betas'`` (B, E), ``'trans'`` (B, 3) and, with the
        kid factor, ``'kid'`` (B,). The loss is the mean over the batch and
        the vertices of the (``vertex_weights``-weighted) distance to
        ``target_vertices``, plus the same over the joints where
        ``target_joints`` is given, plus ``beta_regularizer`` times the mean
        square of the betas from the third on. Returns the loss (a detached
        scalar) and {name: gradient} in ``params``' order.

        The forward pass is ``BodyModel.forward(glob_rotmats=...)`` (K1 on
        the card), the backward the autograd Functions' own (K10). Spans:
        ``refine`` around ``refine.loss`` (the forward pass and the loss) and
        ``refine.backward`` (the autograd call, whose CUDA work the engine
        runs on a thread of its own)."""
        bm = self.body_model
        target_vertices, target_joints, vertex_weights, joint_weights = (
            None if x is None else bm.as_f32(x).detach()
            for x in (target_vertices, target_joints, vertex_weights, joint_weights))
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with profiling.span('refine'):
            with profiling.span('refine.loss'), torch.enable_grad():
                res = bm(glob_rotmats=rot_ops.rot6d_to_rotmat(leaves['rot6d']),
                         shape_betas=leaves['betas'], trans=leaves['trans'],
                         kid_factor=leaves.get('kid'))
                v_diff_norm = torch.linalg.norm(res['vertices'] - target_vertices, dim=-1)
                if vertex_weights is not None:
                    loss = torch.mean(vertex_weights * v_diff_norm)
                else:
                    loss = torch.mean(v_diff_norm)
                if target_joints is not None:
                    j_diff_norm = torch.linalg.norm(res['joints'] - target_joints, dim=-1)
                    if joint_weights is not None:
                        loss = loss + torch.mean(joint_weights * j_diff_norm)
                    else:
                        loss = loss + torch.mean(j_diff_norm)
                if beta_regularizer > 0 and leaves['betas'].shape[1] > 2:
                    loss = loss + beta_regularizer * torch.mean(leaves['betas'][:, 2:] ** 2)
            with profiling.span('refine.backward'):
                grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def _refine(
        self,
        target_vertices,
        target_joints,
        vertex_weights,
        joint_weights,
        init_pose,
        init_betas,
        init_trans,
        init_kid_factor,
        beta_regularizer,
        num_steps,
        lr,
        warmup_ratio,
    ) -> dict:
        bm = self.body_model
        num_joints = bm.num_joints
        target_vertices, target_joints, vertex_weights, joint_weights = (
            None if x is None else bm.as_f32(x).detach()
            for x in (target_vertices, target_joints, vertex_weights, joint_weights))

        with torch.no_grad():
            init_rel = rot_ops.rotvec2mat(bm.as_f32(init_pose).reshape(-1, num_joints, 3))
            init_glob = fk_rotations(bm.kintree_parents, init_rel)
        params = dict(rot6d=rot_ops.rotmat_to_rot6d(init_glob), betas=init_betas,
                      trans=init_trans)
        if init_kid_factor is not None:
            params['kid'] = init_kid_factor
        params = {k: bm.as_f32(v).detach().clone().requires_grad_() for k, v in params.items()}

        schedule = refine_schedule(num_steps, lr, warmup_ratio)
        optimizer = torch.optim.Adam(list(params.values()), lr=0.0, betas=ADAM_BETAS,
                                     eps=ADAM_EPS)
        for k in range(num_steps):
            for group in optimizer.param_groups:
                group['lr'] = schedule(k)
            _, grads = self.loss_and_grad(params, target_vertices, target_joints,
                                          vertex_weights, joint_weights, beta_regularizer)
            for name, grad in grads.items():
                params[name].grad = grad
            optimizer.step()

        with torch.no_grad():
            glob_final = rot_ops.rot6d_to_rotmat(params['rot6d'])
            batch = glob_final.shape[0]
            parents = index_tensor(bm.kintree_parents[1:], bm.device)
            parent_glob = torch.cat([
                torch.eye(3, device=bm.device).expand(batch, 1, 3, 3),
                glob_final[:, parents],
            ], dim=1)
            rel = rot_ops.matmul3x3(parent_glob, glob_final, transpose_a=True)
            pose_rotvecs = rot_ops.mat2rotvec(rel).reshape(batch, num_joints * 3)
        result = dict(pose_rotvecs=pose_rotvecs, shape_betas=params['betas'].detach(),
                      trans=params['trans'].detach())
        if 'kid' in params:
            result['kid_factor'] = params['kid'].detach()
        return result
