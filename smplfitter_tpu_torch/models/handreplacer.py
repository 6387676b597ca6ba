"""Grafting SMPL+H hand poses onto SMPL-topology meshes, ported from
``smplfitter_tpu.models.handreplacer``.

Fits the ``smplh16`` model to the input vertices with the hand vertices
down-weighted (static fit weights), overwrites the hand pose parameters from a
source pose (the left hand mirrored from the right), re-poses, and blends the
new hands in with a smootherstep mask over |x| of the T-pose.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils.modeldata import load_pickle, load_vertex_converter_csr
from .bodyfitter import BodyFitter
from .bodymodel import BodyModel

# SMPL+H's hand joints: 15 on each side after the 22 body joints.
_FIRST_HAND_JOINT = 22
_HAND_JOINTS = 15


def smootherstep(x, x0, x1):
    y = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    return y**3 * (y * (y * 6.0 - 15.0) + 10.0)


class HandReplacer:
    """Replaces the hand regions of SMPL-topology meshes with posed SMPL+H
    hands. Runs on the device of ``smplh_model``; without one it loads
    ``smplh16`` on ``device`` (the CUDA card unless told otherwise)."""

    def __init__(self, hand_pose_source, smplh_model: Optional[BodyModel] = None, *,
                 device='cuda'):
        data_root = os.getenv('DATA_ROOT', '.')
        hand_indices = load_pickle(f'{data_root}/body_models/smplx/MANO_SMPLX_vertex_ids.pkl')
        smplx_hand_indices = list(hand_indices['left_hand']) + list(hand_indices['right_hand'])
        smplx2smpl = load_vertex_converter_csr(
            f'{data_root}/body_models/smplx2smpl_deftrafo_setup.pkl')
        smpl_hand_indices = np.unique((smplx2smpl[:, smplx_hand_indices] > 0.5).nonzero()[0])

        self.smplh_bm = (BodyModel('smplh16', 'neutral', device=device) if smplh_model is None
                         else smplh_model)
        dev = self.smplh_bm.device
        self.hand_indices_all = np.asarray(smpl_hand_indices, dtype=np.int64)

        vertex_weights = np.ones(self.smplh_bm.num_vertices, np.float32)
        vertex_weights[self.hand_indices_all] = 1e-1
        self.vertex_weights = torch.as_tensor(vertex_weights, device=dev)
        # The hand down-weighting is fixed per replacer, so it is baked into
        # the fitter's moments (static weights keep the unweighted kernels'
        # route with their ω forms).
        self.smplh_fitter = BodyFitter(self.smplh_bm, vertex_weights=vertex_weights)

        # Blend mask from the T-pose mesh (thresholds on the host).
        template = self.smplh_fitter.plan.default_mesh_vm[:, :self.smplh_bm.num_vertices, 0].T
        template_np = template.cpu().numpy()
        if len(smpl_hand_indices) > 0:
            hand_min_x = float(np.min(np.abs(template_np[smpl_hand_indices])[:, 0]))
        else:
            hand_min_x = float(np.percentile(np.abs(template_np[:, 0]), 95))
        self.hand_mix_weight = smootherstep(torch.abs(template[:, 0]), hand_min_x - 0.1,
                                            hand_min_x)

        self.hand_pose_source = self.smplh_bm.as_f32(hand_pose_source).reshape(-1)

    def mirror_rotvecs(self, hand_pose: torch.Tensor) -> torch.Tensor:
        hflip = torch.tensor([1.0, -1.0, -1.0], dtype=hand_pose.dtype, device=hand_pose.device)
        return (hand_pose.reshape(-1, 3) * hflip).reshape(-1)

    def copy_hand_params(self, smplh_pose: torch.Tensor) -> torch.Tensor:
        """Overwrite the 2 x 15 hand-joint rotvecs of (B, 3J) poses from the
        source pose (right hand as is; left hand mirrored from the right).
        Returns a new tensor; the input is not written."""
        left = _FIRST_HAND_JOINT * 3
        right = (_FIRST_HAND_JOINT + _HAND_JOINTS) * 3
        end = (_FIRST_HAND_JOINT + 2 * _HAND_JOINTS) * 3
        batch = smplh_pose.shape[0]
        src_right = self.hand_pose_source[right:end]
        return torch.cat([
            smplh_pose[:, :left],
            self.mirror_rotvecs(src_right).expand(batch, -1),
            src_right.expand(batch, -1),
            smplh_pose[:, end:],
        ], dim=1)

    def replace_hand(self, smpl_verts) -> torch.Tensor:
        """Return (B, V, 3) ``smpl_verts`` with the hand regions replaced by
        the posed hands."""
        smpl_verts = self.smplh_bm.as_f32(smpl_verts)
        fit = self.smplh_fitter.fit(
            target_vertices=smpl_verts,
            num_iter=3,
            beta_regularizer=0.0,
            final_adjust_rots=False,
            requested_keys=('pose_rotvecs', 'shape_betas'),
        )
        new_pose = self.copy_hand_params(fit['pose_rotvecs'])
        new_res = self.smplh_bm(pose_rotvecs=new_pose, shape_betas=fit['shape_betas'],
                                trans=fit['trans'])
        new_verts = new_res['vertices']
        return smpl_verts + (new_verts - smpl_verts) * self.hand_mix_weight[:, None]
