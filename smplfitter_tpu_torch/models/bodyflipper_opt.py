"""Mirroring with gradient refinement, ported from
``smplfitter_tpu.models.bodyflipper_opt``.

The closed-form flip (:class:`BodyFlipper`), then the Adam refinement of
:class:`BodyFitterOpt` against the mirrored mesh.
"""

from __future__ import annotations

from .bodyfitter_opt import BodyFitterOpt
from .bodyflipper import BodyFlipper
from .bodymodel import BodyModel


class BodyFlipperOpt:
    """Horizontally flips body parameters, with optional Adam refinement."""

    def __init__(self, body_model: BodyModel):
        self.body_model = body_model
        self.flipper = BodyFlipper(body_model)
        self.fitter_opt = BodyFitterOpt(body_model)

    def flip(
        self,
        pose_rotvecs,
        shape_betas,
        trans,
        kid_factor=None,
        num_iter: int = 1,
        refine_steps: int = 0,
        refine_lr: float = 0.03,
    ) -> dict:
        """Flipped parameters; ``refine_steps > 0`` adds Adam refinement against
        the mirrored target mesh (beta_regularizer 1e-2)."""
        init = self.flipper.flip(pose_rotvecs, shape_betas, trans, kid_factor, num_iter)
        if refine_steps == 0:
            return init

        inp = self.body_model(pose_rotvecs=pose_rotvecs, shape_betas=shape_betas, trans=trans,
                              kid_factor=kid_factor)
        flipped_vertices = self.flipper.flip_vertices(inp['vertices'])
        return self.fitter_opt._refine(
            flipped_vertices,
            None,
            None,
            None,
            init['pose_rotvecs'],
            init['shape_betas'],
            init['trans'],
            init.get('kid_factor'),
            beta_regularizer=1e-2,
            num_steps=refine_steps,
            lr=refine_lr,
            warmup_ratio=0.5,
        )
