"""Body parameters drawn on the device from a run's generator."""

from __future__ import annotations

import torch


def draw_params(ctx, gen, B):
    """Pose rotation vectors N(0, pose_std) (B, 3J), betas N(0, 1) (B, E) and
    translations N(0, 0.5) (B, 3), in that order, as float32 on the device."""
    cfg, dev = ctx.config, ctx.device
    J, E = cfg['num_joints'], cfg['num_betas']
    pose = torch.randn((B, 3 * J), generator=gen, device=dev) * cfg['target_pose_std']
    betas = torch.randn((B, E), generator=gen, device=dev)
    trans = torch.randn((B, 3), generator=gen, device=dev) * 0.5
    return pose, betas, trans
