"""Parameter conversion between SMPL-family body models, ported from
``smplfitter_tpu.models.bodyconverter``.

Converts (pose, betas, trans) of one model family to another: the input
model's mesh is carried to the output topology through a fixed barycentric
correspondence (the deftrafo setup files), and the output model is fitted to
it. The sparse transfer matrix (at most ~3 nonzeros per row) becomes a
fixed-width gather at construction, so the transfer runs on the device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..utils.modeldata import csr_to_dense_gather, load_vertex_converter_csr
from .bodyfitter import BodyFitter
from .bodymodel import BodyModel


def _deftrafo_path(num_verts_in: int, num_verts_out: int) -> Optional[str]:
    """The deformation-transfer setup file for a model pair, or None if the
    topologies match (no conversion needed)."""
    if num_verts_in == num_verts_out:
        return None
    data_root = os.getenv('DATA_ROOT', '.')
    if num_verts_in < num_verts_out:
        return f'{data_root}/body_models/smpl2smplx_deftrafo_setup.pkl'
    return f'{data_root}/body_models/smplx2smpl_deftrafo_setup.pkl'


class VertexConverter:
    """Fixed-width gather form of a sparse vertex-transfer matrix, on ``device``."""

    def __init__(self, csr, device='cuda'):
        indices, weights = csr_to_dense_gather(csr)
        self.indices = torch.as_tensor(indices, dtype=torch.int64, device=device)  # (V_out, k)
        self.weights = torch.as_tensor(weights, device=device)  # (V_out, k)

    def __call__(self, vertices: torch.Tensor) -> torch.Tensor:
        """(B, V_in, 3) -> (B, V_out, 3): the weighted sum over k of the
        gathered rows, accumulated k = 0, 1, ... (no (B, V_out, k, 3)
        intermediate)."""
        out = vertices[:, self.indices[:, 0]] * self.weights[:, 0, None]
        for k in range(1, self.indices.shape[1]):
            out = out + vertices[:, self.indices[:, k]] * self.weights[:, k, None]
        return out


class BodyConverter:
    """Converts between body model parametrizations (e.g. SMPL <-> SMPL-X),
    on the device of the models."""

    def __init__(self, body_model_in: BodyModel, body_model_out: BodyModel):
        self.body_model_in = body_model_in
        self.body_model_out = body_model_out
        # The kid column is always on and suppressed by regularization (1e9)
        # when the input has no kid factor: one solve shape for every call.
        self.fitter = BodyFitter(body_model_out, enable_kid=True)

        csr_path = _deftrafo_path(body_model_in.num_vertices, body_model_out.num_vertices)
        self.vertex_converter: Optional[VertexConverter] = (
            None if csr_path is None
            else VertexConverter(load_vertex_converter_csr(csr_path), body_model_out.device))

    def convert(
        self,
        pose_rotvecs,
        shape_betas,
        trans,
        kid_factor=None,
        known_output_pose_rotvecs=None,
        known_output_shape_betas=None,
        known_output_kid_factor=None,
        num_iter: int = 1,
    ) -> dict:
        """Convert input parameters to the output model's parametrization:
        a free fit of pose, shape and translation; with
        ``known_output_shape_betas`` (and ``known_output_kid_factor``) a fit
        of pose and translation to that shape; with
        ``known_output_pose_rotvecs`` a fit of shape and translation to that
        pose. Returns the fitted pose_rotvecs / shape_betas and trans (and
        kid_factor where ``kid_factor`` is given and the shape is fitted).
        """
        inp = self.body_model_in(pose_rotvecs=pose_rotvecs, shape_betas=shape_betas,
                                 trans=trans, kid_factor=kid_factor)
        verts = self.convert_vertices(inp['vertices'])

        if known_output_shape_betas is not None:
            fit = self.fitter.fit_with_known_shape(
                shape_betas=known_output_shape_betas,
                kid_factor=known_output_kid_factor,
                target_vertices=verts,
                num_iter=num_iter,
                final_adjust_rots=False,
                requested_keys=('pose_rotvecs',),
            )
            return dict(pose_rotvecs=fit['pose_rotvecs'], trans=fit['trans'])
        if known_output_pose_rotvecs is not None:
            fit = self.fitter.fit_with_known_pose(
                pose_rotvecs=known_output_pose_rotvecs,
                target_vertices=verts,
                beta_regularizer=0.0,
                kid_regularizer=1e9 if kid_factor is None else 0.0,
            )
            out = dict(shape_betas=fit['shape_betas'], trans=fit['trans'])
        else:
            fit = self.fitter.fit(
                target_vertices=verts,
                num_iter=num_iter,
                beta_regularizer=0.0,
                final_adjust_rots=False,
                kid_regularizer=1e9 if kid_factor is None else 0.0,
                requested_keys=('pose_rotvecs', 'shape_betas'),
            )
            out = dict(pose_rotvecs=fit['pose_rotvecs'], shape_betas=fit['shape_betas'],
                       trans=fit['trans'])
        if kid_factor is not None:
            out['kid_factor'] = fit['kid_factor']
        return out

    def convert_vertices(self, inp_vertices) -> torch.Tensor:
        """Transfer (B, V_in, 3) vertices to the output topology (the same
        tensor if the topologies match)."""
        inp_vertices = self.body_model_in.as_f32(inp_vertices)
        if self.vertex_converter is None:
            return inp_vertices
        return self.vertex_converter(inp_vertices)
