"""Horizontal (x-axis) mirroring of body model parameters, ported from
``smplfitter_tpu.models.bodyflipper``.

Flips and reorders the mesh vertices through a mirror correspondence, then
refits the parameters, warm-started from the naively sign-flipped pose. The
sparse composition and the Hungarian mirror assignment run once, on the host,
at construction; a flip runs a gather and the fit on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.modeldata import load_vertex_converter_csr
from .bodyconverter import VertexConverter
from .bodyfitter import BodyFitter
from .bodymodel import BodyModel


def load_mirror_csr(path: str):
    """Build the smplx mirror CSR from flip correspondences (vertex triples +
    barycentric weights)."""
    import scipy.sparse

    m = np.load(path)
    corner_ids = m['closest_faces']  # (V, 3) vertex indices of the closest face
    barycentrics = m['bc']  # (V, 3)
    n_verts = barycentrics.shape[0]
    data = barycentrics.flatten()
    row = np.repeat(np.arange(corner_ids.shape[0]), 3)
    col = corner_ids.flatten()
    coo = scipy.sparse.coo_matrix((data, (row, col)), shape=(corner_ids.shape[0], n_verts))
    return coo.tocsr().astype(np.float32)


def get_mirror_csr(num_verts: int):
    """Mirror correspondence matrix for SMPL-X directly, or composed through
    the smpl<->smplx transfers for SMPL topology."""
    data_root = os.getenv('DATA_ROOT', '.')
    smplx2mirror = load_mirror_csr(
        f'{data_root}/body_models/smplx/smplx_flip_correspondences.npz')
    if num_verts == smplx2mirror.shape[0]:
        return smplx2mirror
    smpl2smplx = load_vertex_converter_csr(
        f'{data_root}/body_models/smpl2smplx_deftrafo_setup.pkl')
    smplx2smpl = load_vertex_converter_csr(
        f'{data_root}/body_models/smplx2smpl_deftrafo_setup.pkl')
    if num_verts != smplx2smpl.shape[0]:
        raise ValueError(f'Unsupported number of vertices: {num_verts}')
    return smplx2smpl @ smplx2mirror @ smpl2smplx


def get_mirror_mapping(points: np.ndarray) -> np.ndarray:
    """Index mapping to the mirrored counterpart of each point (Hungarian
    assignment on the dense distances to the x-negated set)."""
    import scipy.optimize
    import scipy.spatial.distance

    points = np.asarray(points)
    dist = scipy.spatial.distance.cdist(points, points * [-1, 1, 1])
    v_inds, mirror_inds = scipy.optimize.linear_sum_assignment(dist)
    return mirror_inds[np.argsort(v_inds)]


class BodyFlipper:
    """Mirrors body model parameters along the x axis, on the model's device."""

    def __init__(self, body_model: BodyModel):
        self.body_model = body_model
        self.fitter = BodyFitter(body_model, enable_kid=True)
        dev = body_model.device

        self.mirror_converter = VertexConverter(get_mirror_csr(body_model.num_vertices), dev)
        # The T-pose mesh and joints on the host for the mirror index mappings.
        default_mesh = self.fitter.plan.default_mesh_vm[:, :body_model.num_vertices, 0]
        default_mesh = default_mesh.T.cpu().numpy()
        joints = body_model.J_template.cpu().numpy()
        self.mirror_inds_joints = torch.as_tensor(get_mirror_mapping(joints), device=dev)
        self.mirror_inds = torch.as_tensor(get_mirror_mapping(default_mesh), device=dev)

    def flip(
        self,
        pose_rotvecs,
        shape_betas,
        trans,
        kid_factor=None,
        num_iter: int = 1,
    ) -> dict:
        """Parameters of the horizontally flipped body (x-mirrored):
        pose_rotvecs, shape_betas, trans and kid_factor."""
        bm = self.body_model
        inp = bm(pose_rotvecs=pose_rotvecs, shape_betas=shape_betas, trans=trans,
                 kid_factor=kid_factor)
        flipped_vertices = self.flip_vertices(inp['vertices'])

        fit = self.fitter.fit(
            target_vertices=flipped_vertices,
            num_iter=num_iter,
            beta_regularizer=1e-2,
            beta_regularizer2=1e-2,
            final_adjust_rots=True,
            kid_regularizer=1e9 if kid_factor is None else 0.0,
            initial_pose_rotvecs=self.naive_flip_rotvecs(pose_rotvecs),
            initial_shape_betas=bm.as_f32(shape_betas),
            requested_keys=('pose_rotvecs', 'shape_betas'),
        )
        out = dict(pose_rotvecs=fit['pose_rotvecs'], shape_betas=fit['shape_betas'],
                   trans=fit['trans'])
        if 'kid_factor' in fit:
            out['kid_factor'] = fit['kid_factor']
        return out

    def flip_vertices(self, inp_vertices) -> torch.Tensor:
        """Mirror (B, V, 3) vertices: reorder via the correspondence, negate x."""
        inp_vertices = self.body_model.as_f32(inp_vertices)
        hflip = torch.tensor([-1.0, 1.0, 1.0], device=inp_vertices.device)
        return self.mirror_converter(inp_vertices) * hflip

    def naive_flip_rotvecs(self, pose_rotvecs) -> torch.Tensor:
        """Sign-flip each rotvec ([1, -1, -1]) and swap left/right body parts
        (B, 3J). Ignores the slight asymmetry of the body model; the flip's
        warm start."""
        pose_rotvecs = self.body_model.as_f32(pose_rotvecs)
        J = self.body_model.num_joints
        hflip = torch.tensor([1.0, -1.0, -1.0], device=pose_rotvecs.device)
        reshaped = pose_rotvecs.reshape(-1, J, 3)
        flipped = reshaped[:, self.mirror_inds_joints] * hflip
        return flipped.reshape(-1, J * 3)
