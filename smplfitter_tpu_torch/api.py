"""Differentiating through the fit, ported from ``smplfitter_tpu.api``.

:func:`get_fit_grad_fn` is the recipe for training a network with a loss
taken through the closed-form fit: the value and gradient, with respect to
the target vertices and joints, of a scalar loss of the fit's results. On the
card the gradient runs through the backward kernels (K10-K15) of the fit's
kernel forms, and through PyTorch ops where the JAX package has no custom VJP
either (K2's scale forms, per-call fit weights, K9; see
``ops/lbs_kernels.py``).

Every entry point of ``BodyFitter`` is differentiable the same way: the
other paths (fits without target joints, warm starts, ``scale_fit`` /
``scale_target``, fit weights, ``fit_with_known_shape``,
``fit_with_known_pose``) are differentiated with ``torch.autograd.grad`` of
a loss of their results, as :func:`get_fit_grad_fn` does for ``fit`` with
target joints (the JAX package's signature).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .models.bodyfitter import BodyFitter


def default_loss(res: dict) -> torch.Tensor:
    """:func:`get_fit_grad_fn`'s default loss: the summed squares of a fit
    result's shape betas, translation and pose rotation vectors."""
    return ((res['shape_betas'] ** 2).sum() + (res['trans'] ** 2).sum()
            + (res['pose_rotvecs'] ** 2).sum())


def get_fit_grad_fn(fitter: BodyFitter, chunk: Optional[int] = None, num_iter: int = 3,
                    beta_regularizer: float = 1.0, final_adjust_rots: bool = True,
                    loss_fn: Optional[Callable[[dict], torch.Tensor]] = None):
    """``vg(target_vertices, target_joints) -> (value, (g_tv, g_tj))``: the
    value and gradient of a scalar loss of ``fitter.fit``'s results (default:
    the summed squares of pose rotation vectors, betas and translation; pass
    ``loss_fn(result_dict)`` for another). The fit runs with ``num_iter``,
    ``beta_regularizer`` and ``final_adjust_rots`` and returns pose_rotvecs,
    shape_betas and trans.

    Fits are independent per instance, so a summed loss and its gradient
    decompose over the batch: with ``chunk``, a batch that is a larger
    multiple of it is fitted ``chunk`` instances at a time, the chunk losses
    summed and their gradients written into one result, which bounds the
    memory the backward pass keeps. A loss that couples instances must not be
    chunked. Targets (B, V, 3) and (B, J, 3) go to the fitter's device; the
    value is a 0-d tensor there, the gradients have the targets' shapes.
    """
    def fit_loss(tv, tj):
        res = fitter.fit(tv, tj, num_iter=num_iter, beta_regularizer=beta_regularizer,
                         final_adjust_rots=final_adjust_rots,
                         requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
        return (default_loss if loss_fn is None else loss_fn)(res)

    def vg(target_vertices, target_joints):
        bm = fitter.body_model
        tv = bm.as_f32(target_vertices).detach()
        tj = bm.as_f32(target_joints).detach()
        B = tv.shape[0]
        n = chunk if chunk and B > chunk and B % chunk == 0 else B
        value = torch.zeros((), device=tv.device)
        g_tv, g_tj = torch.empty_like(tv), torch.empty_like(tj)
        for s in range(0, B, n):
            tvc = tv[s:s + n].clone().requires_grad_()
            tjc = tj[s:s + n].clone().requires_grad_()
            with torch.enable_grad():
                loss = fit_loss(tvc, tjc)
                g_tv[s:s + n], g_tj[s:s + n] = torch.autograd.grad(loss, (tvc, tjc))
            value += loss.detach()
        return value, (g_tv, g_tj)

    return vg
