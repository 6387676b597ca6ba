"""Batch data parallelism over ``torch.distributed``, ported from
``smplfitter_tpu.parallel.sharding``.

The fit is independent per instance. The only sums across instances are the
shared solves of ``share_beta`` (``ops.lstsq.batch_reduce_sum``: the summed
Schur complement and moment of the shape). So data parallelism is: every rank
fits a contiguous slice of the global batch on its own device, those sums are
completed by an all-reduce over the process group (:func:`cross_shard`), and
the outputs are gathered (:func:`make_sharded_fit_fn`). The collective backend
is the group's: NCCL between cards, gloo on the CPU.

The JAX package's mesh and compiler objects have no counterpart here:
``make_mesh``, ``batch_sharding``, ``replicated``, ``method='gspmd'`` and
``donate``. Nor has ``kernel_batch_pad``: the port's kernels take any batch.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ..ops import lstsq as _lstsq


def _world(group) -> tuple[int, int]:
    """(world size, rank) of ``group`` (None: the default group)."""
    return dist.get_world_size(group), dist.get_rank(group)


def padded_global_batch(batch: int, world_size: int) -> int:
    """The smallest global batch >= ``batch`` that splits evenly over
    ``world_size`` ranks: ``ceil(batch / world_size) * world_size``."""
    return -(-batch // world_size) * world_size


@contextlib.contextmanager
def cross_shard(group=None):
    """Run the enclosed fit on this rank's slice of a batch whose other slices
    are on the other ranks of ``group`` (None: the default group): the
    ``share_beta`` sums over the batch are completed by an all-reduce over
    the group, in f64. Scoped by a ContextVar: only the code that opened the
    region sees it."""
    token = _lstsq.CROSS_SHARD_GROUP.set((group,))
    try:
        yield
    finally:
        _lstsq.CROSS_SHARD_GROUP.reset(token)


def _slice_of(n: int, world: int, rank: int) -> slice:
    if n % world:
        raise ValueError(f'a batch of {n} does not split over {world} ranks: pad it to '
                         f'padded_global_batch({n}, {world}) = {padded_global_batch(n, world)}')
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(tree, group=None):
    """This rank's contiguous slice of every batched array (a tensor or numpy
    array with a leading dimension) in a dict, list or tuple tree; the batch
    must split evenly over the group's ranks."""
    world, rank = _world(group)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if getattr(x, 'ndim', 0) > 0:
            return x[_slice_of(x.shape[0], world, rank)]
        return x

    return take(tree)


class _Scatter(torch.autograd.Function):
    """This rank's slice of a global batch that every rank holds; the
    backward pass gathers the slices' gradients, so every rank gets the
    gradient of the whole input."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.group, ctx.world = group, world
        return x[_slice_of(x.shape[0], world, rank)].clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.world)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts), None, None, None


class _Gather(torch.autograd.Function):
    """The global batch from every rank's slice. Every rank takes the global
    result (and a loss of it) as its own, so the backward pass keeps this
    rank's slice of the gradient; the all-reduce of the shared sums adds the
    other ranks' parts where the instances couple."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.rows = slice(rank * x.shape[0], (rank + 1) * x.shape[0])
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return g[ctx.rows], None, None, None


def _pad(x: Optional[torch.Tensor], pad: int):
    """``x`` with ``pad`` copies of its last instance appended."""
    if x is None or pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def make_sharded_fit_fn(fitter, group=None, pad_to_mesh: bool = True, **fit_kwargs):
    """``fit(verts, joints=None, vertex_weights=None, joint_weights=None,
    batch_mask=None)``: ``fitter.fit`` with ``fit_kwargs``, its batch split
    over the ranks of ``group`` (None: the default group).

    Every rank calls it with the same global batch. The batch is padded to
    :func:`padded_global_batch` by copies of its last instance (a zero
    ``batch_mask`` tail keeps them out of ``share_beta``'s shared solve; it
    is added where ``share_beta`` is set or a mask is given). Each rank fits
    its slice inside :func:`cross_shard`, the outputs are gathered along the
    batch and cut back to the real batch: every rank returns the global
    result. Without ``pad_to_mesh`` the batch must split evenly.

    The function is differentiable: a loss of the global result, taken on
    every rank, has on every rank the gradient of the unsharded fit's loss
    with respect to the global inputs. With no initialized process group it
    is the plain fit.
    """
    share_beta = fit_kwargs.get('share_beta', False)

    def fit(verts, joints=None, vertex_weights=None, joint_weights=None, batch_mask=None):
        if not (dist.is_available() and dist.is_initialized()):
            return fitter.fit(verts, joints, vertex_weights, joint_weights,
                              batch_mask=batch_mask, **fit_kwargs)
        world, rank = _world(group)
        bm = fitter.body_model
        inputs = [None if x is None else bm.as_f32(x)
                  for x in (verts, joints, vertex_weights, joint_weights)]
        B = inputs[0].shape[0]
        pad = (padded_global_batch(B, world) if pad_to_mesh else B) - B
        inputs = [_pad(x, pad) for x in inputs]
        if pad and (share_beta or batch_mask is not None):
            mask = (torch.ones(B, device=bm.device) if batch_mask is None
                    else bm.as_f32(batch_mask))
            batch_mask = torch.cat([mask, torch.zeros(pad, device=bm.device)])
        if batch_mask is not None:
            batch_mask = bm.as_f32(batch_mask)
        local = [None if x is None else _Scatter.apply(x, group, world, rank)
                 for x in inputs + [batch_mask]]
        with cross_shard(group):
            out = fitter.fit(*local[:4], batch_mask=local[4], **fit_kwargs)
        return {k: _Gather.apply(v, group, world, rank)[:B] for k, v in out.items()}

    return fit
