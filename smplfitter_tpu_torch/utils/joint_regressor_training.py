"""Training sparse convex post-LBS joint regressors for vertex subsets,
ported from ``smplfitter_tpu.utils.joint_regressor_training``.

A fit on a vertex subset without target joints regresses the joints from the
POSED subset vertices. This trains that regressor: each row a convex
combination (softplus weights, normalized), kept sparse by an L-1/2 penalty,
in two phases: dense training, then the weights below a threshold zeroed and
the rest fine-tuned under that fixed mask. The body model is the data: each
step poses a fresh random batch by the model's forward pass (the K1 kernel
on the card), without gradient; the gradient is only in the regressor's
weights.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F

from ..models.bodymodel import BodyModel


def train_post_lbs_regressor(
    body_model: BodyModel,
    vertex_subset: np.ndarray,
    num_steps: int = 400,
    finetune_steps: int = 200,
    batch_size: int = 64,
    lr: float = 1e-1,
    sparsity_weight: float = 1e-5,
    keep_threshold: float = 1e-3,
    pose_std: float = 0.3,
    beta_std: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Learn a sparse convex (J, len(vertex_subset)) post-LBS joint regressor.

    Phase 1 trains dense softplus-normalized weights with an L-1/2 sparsity
    penalty by Adam (``lr``); phase 2 zeroes the weights below
    ``keep_threshold`` (after normalization) and fine-tunes the survivors
    under that mask with a fresh Adam. Both start from the clipped inverse
    softplus of the model's post-LBS regressor restricted to the subset. The
    body batches (pose N(0, ``pose_std``), betas N(0, ``beta_std``)) come
    from a ``torch.Generator`` on the model's device seeded with ``seed``
    (phase 2: ``seed + 1``).
    """
    bm = body_model
    dev = bm.device
    subset_np = np.asarray(vertex_subset, np.int64)
    subset = torch.as_tensor(subset_np, device=dev)
    J, S = bm.num_joints, bm.num_betas

    # Warm start from the post-LBS regressor restricted to the subset.
    init = np.maximum(np.asarray(bm.model_data.J_regressor_post_lbs)[:, subset_np], 0) + 1e-3
    params = torch.tensor(np.log(np.expm1(init)), dtype=torch.float32, device=dev)

    def regressor(p, mask=None):
        w = F.softplus(p)
        if mask is not None:
            w = w * mask
        return w / w.sum(dim=1, keepdim=True)

    def train_phase(p, mask, steps, phase_seed):
        p = p.detach().clone().requires_grad_()
        opt = torch.optim.Adam([p], lr=lr)
        gen = torch.Generator(device=dev).manual_seed(phase_seed)
        for _ in range(steps):
            with torch.no_grad():
                pose = torch.randn((batch_size, J * 3), generator=gen, device=dev) * pose_std
                betas = torch.randn((batch_size, S), generator=gen, device=dev) * beta_std
                res = bm(pose_rotvecs=pose, shape_betas=betas)
            verts, joints = res['vertices'][:, subset], res['joints']
            w = regressor(p, mask)
            pred = torch.einsum('jv,bvc->bjc', w, verts)
            mse = ((pred - joints) ** 2).sum(dim=-1).mean()
            loss = mse + sparsity_weight * torch.sqrt(w + 1e-8).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
        return p.detach()

    params = train_phase(params, None, num_steps, seed)
    # Threshold and fine-tune under a fixed sparsity mask.
    mask = (regressor(params) > keep_threshold).float()
    params = train_phase(params, mask, finetune_steps, seed + 1)
    return regressor(params, mask).cpu().numpy()


def make_vertex_subset_assets(
    body_model: BodyModel,
    subset_size: int,
    model_root: str,
    **train_kwargs,
) -> tuple:
    """Decimate the model's template to ``subset_size`` vertices, train their
    post-LBS regressor, and save both files that
    ``BodyModel(vertex_subset_size=subset_size)`` loads from ``model_root``:
    ``vertex_subset_{n}.npz`` (``i_verts``, ``faces``) and
    ``vertex_subset_joint_regr_post_lbs_{n}.npy``. Returns (subset, regressor)."""
    from .decimation import decimate

    subset, dec_faces = decimate(np.asarray(body_model.model_data.v_template),
                                 np.asarray(body_model.faces), subset_size)
    np.savez(osp.join(model_root, f'vertex_subset_{subset_size}.npz'), i_verts=subset,
             faces=dec_faces)
    regressor = train_post_lbs_regressor(body_model, subset, **train_kwargs)
    np.save(osp.join(model_root, f'vertex_subset_joint_regr_post_lbs_{subset_size}.npy'),
            regressor)
    return subset, regressor
