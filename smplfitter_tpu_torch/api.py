"""Cached models and fit functions, and differentiating through the fit,
ported from ``smplfitter_tpu.api``.

:func:`get_cached_body_model` and :func:`get_cached_fit_fn` keep one model
(and one fitter) per configuration, so repeated calls with the same
configuration reuse the model's device buffers and precomputed operands. The
fit function takes any leading batch dimensions, and its ``.ragged`` fits
sequences of different lengths in one padded call.

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

import functools
from typing import Callable, Optional

import numpy as np
import torch

from .models.bodyfitter import BodyFitter
from .models.bodymodel import BodyModel


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
    chunked, nor may the loss of a ``share_beta`` fit, whose instances share
    one shape (a loss of such a fit, differentiated with
    ``torch.autograd.grad`` as in the module docstring, runs monolithic).
    Targets (B, V, 3) and (B, J, 3) go to the fitter's device; the
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


@functools.lru_cache()
def get_cached_body_model(model_name: str = 'smpl', gender: str = 'neutral',
                          model_root: Optional[str] = None, *, device='cuda') -> BodyModel:
    """One shared ``BodyModel`` per configuration (do not modify it in place)."""
    return BodyModel(model_name=model_name, gender=gender, model_root=model_root, device=device)


@functools.lru_cache()
def get_cached_fit_fn(
    body_model_name: str = 'smpl',
    gender: str = 'neutral',
    num_betas: int = 10,
    enable_kid: bool = False,
    requested_keys: tuple = ('pose_rotvecs', 'shape_betas', 'trans'),
    beta_regularizer: float = 1.0,
    beta_regularizer2: float = 0.0,
    num_iter: int = 3,
    vertex_subset: Optional[tuple] = None,
    vertex_subset_size: Optional[int] = None,
    joint_regressor_post_lbs: Optional[tuple] = None,
    share_beta: bool = False,
    final_adjust_rots: bool = True,
    scale_target: bool = False,
    scale_fit: bool = False,
    scale_regularizer: float = 0.0,
    kid_regularizer: Optional[float] = None,
    *,
    device='cuda',
):
    """A fit function for one fixed configuration, built once per
    configuration (the arguments must be hashable: tuples for the subset
    and the regressor).

    ``fn(verts, joints=None, vertex_weights=None, joint_weights=None)`` takes
    targets (..., V, 3) and (..., J, 3) and weights (..., V) and (..., J)
    with any leading batch dimensions, fits them as one batch and returns
    each result with those leading dimensions. ``fn.ragged`` fits a list of
    sequences of different lengths in one call (see its docstring)."""
    body_model = BodyModel(
        model_name=body_model_name, gender=gender, num_betas=num_betas,
        vertex_subset=None if vertex_subset is None else list(vertex_subset),
        vertex_subset_size=vertex_subset_size,
        joint_regressor_post_lbs=(None if joint_regressor_post_lbs is None
                                  else np.asarray(joint_regressor_post_lbs)),
        device=device)
    fitter = BodyFitter(body_model, enable_kid=enable_kid)
    V = body_model.num_vertices
    J = body_model.num_joints

    def fit_fn(verts, joints=None, vertex_weights=None, joint_weights=None, batch_mask=None):
        return fitter.fit(
            verts, target_joints=joints, vertex_weights=vertex_weights,
            joint_weights=joint_weights, num_iter=num_iter, beta_regularizer=beta_regularizer,
            beta_regularizer2=beta_regularizer2, scale_regularizer=scale_regularizer,
            kid_regularizer=kid_regularizer, share_beta=share_beta,
            final_adjust_rots=final_adjust_rots, scale_target=scale_target,
            scale_fit=scale_fit, requested_keys=requested_keys, batch_mask=batch_mask)

    def flat(x, *tail):
        return None if x is None else body_model.as_f32(x).reshape(-1, *tail)

    def wrapped(verts, joints=None, vertex_weights=None, joint_weights=None):
        verts = body_model.as_f32(verts)
        lead = verts.shape[:-2]
        res = fit_fn(verts.reshape(-1, V, 3), flat(joints, J, 3), flat(vertex_weights, V),
                     flat(joint_weights, J))
        return {k: v.reshape(*lead, *v.shape[1:]) for k, v in res.items()}

    def ragged(verts_seqs, joints_seqs=None, vertex_weights_seqs=None, joint_weights_seqs=None):
        """Fit sequences of different lengths in one call.

        The sequences are joined into one batch of frames, padded up to a
        bucket, the next power of two and at least 8, by repeats of the last
        frame, fitted once and split back per sequence. A ``batch_mask``
        zero on the padding keeps it out of ``share_beta``'s shared shape,
        which couples every frame of the call, across sequences.

        Arguments are lists of per-sequence arrays: verts (T_i, V, 3), and
        optionally joints (T_i, J, 3), vertex weights (T_i, V) and joint
        weights (T_i, J). Returns each requested key as a list of
        per-sequence results (T_i leading)."""
        lengths = [int(v.shape[0]) for v in verts_seqs]
        n = sum(lengths)
        if n == 0:
            raise ValueError('ragged fit needs at least one frame')
        bucket = max(8, 1 << (n - 1).bit_length())
        pad = bucket - n

        def cat(seqs):
            frames = torch.cat([body_model.as_f32(x) for x in seqs], dim=0)
            if pad:
                frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])], dim=0)
            return frames

        mask = (torch.arange(bucket, device=body_model.device) < n).to(torch.float32)
        res = fit_fn(cat(verts_seqs), None if joints_seqs is None else cat(joints_seqs),
                     None if vertex_weights_seqs is None else cat(vertex_weights_seqs),
                     None if joint_weights_seqs is None else cat(joint_weights_seqs),
                     batch_mask=mask)
        splits = np.cumsum([0] + lengths)
        return {k: [v[splits[i]:splits[i + 1]] for i in range(len(lengths))]
                for k, v in res.items()}

    wrapped.ragged = ragged
    return wrapped
