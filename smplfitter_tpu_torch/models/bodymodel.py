"""SMPL-family body model forward pass in PyTorch, ported from
``smplfitter_tpu.models.bodymodel``.

Forward kinematics runs level-batched over the kinematic tree (one gather,
3x3 product and scatter per tree level), and the pose-blend plus skinning runs
as one extended-LBS kernel (:func:`~smplfitter_tpu_torch.ops.lbs_kernels.lbs_points`)
over component-major operands precomputed on the host at construction.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import lbs_kernels
from ..ops import rotation as rot_ops
from ..utils import modeldata as _modeldata
from ..utils import profiling


@functools.lru_cache(maxsize=None)
def tree_levels(kintree_parents: tuple) -> tuple:
    """Partition joints 1..J-1 into kinematic-tree levels (root excluded).

    All joints in a level have parents in strictly earlier levels, so each level
    can be updated with one batched gather/matmul/scatter.
    """
    J = len(kintree_parents)
    depth = [0] * J
    for i in range(1, J):
        depth[i] = depth[kintree_parents[i]] + 1
    max_depth = max(depth) if J > 1 else 0
    return tuple(
        tuple(i for i in range(J) if depth[i] == d) for d in range(1, max_depth + 1)
    )


def index_tensor(values, device) -> torch.Tensor:
    """A static index list as a cached int64 tensor on ``device`` (so gathers by
    a constant index copy nothing from the host per call)."""
    return _cached_index(tuple(int(v) for v in values), torch.device(device))


@functools.lru_cache(maxsize=None)
def _cached_index(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def fk_rotations(parents: tuple, rel_rotmats: torch.Tensor) -> torch.Tensor:
    """Compose parent-relative rotations into global ones, level by level.

    rel_rotmats: (B, J, 3, 3) -> glob_rotmats: (B, J, 3, 3).
    """
    dev = rel_rotmats.device
    glob = rel_rotmats.clone()
    for level in tree_levels(parents):
        js = index_tensor(level, dev)
        ps = index_tensor([parents[i] for i in level], dev)
        glob[:, js] = rot_ops.matmul3x3(glob[:, ps], rel_rotmats[:, js])
    return glob


def fk_positions(parents: tuple, glob_rotmats: torch.Tensor, bones: torch.Tensor) -> torch.Tensor:
    """Accumulate joint positions down the tree, level by level.

    ``bones``: (B, J, 3) parent-to-joint offsets in the shaped T-pose (the root
    entry is the root position itself). Returns (B, J, 3) global positions.
    """
    dev = bones.device
    pos = bones.clone()
    for level in tree_levels(parents):
        js = index_tensor(level, dev)
        ps = index_tensor([parents[i] for i in level], dev)
        pos[:, js] = pos[:, ps] + rot_ops.matvec3(glob_rotmats[:, ps], bones[:, js])
    return pos


def _model_device(device) -> torch.device:
    """The device a model is built on: the CUDA card unless the caller names
    another; a CUDA device without one present is an error, never the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'BodyModel(device={str(device)!r}): no CUDA device is available; '
                           "pass device='cpu' to run on the CPU")
    return device


class BodyModel(nn.Module):
    """SMPL-family body model (SMPL, SMPL-X, SMPL+H, MANO). Constants are
    float32 buffers on ``device``: the CUDA card by default, ``device='cpu'``
    for the CPU.

    ``BodyModel(model_name, gender, model_root, num_betas, device=...)`` loads
    the model files like the JAX package; :meth:`from_model_data` builds it
    from an already loaded :class:`~smplfitter_tpu_torch.utils.modeldata.ModelData`.

    A vertex subset makes the model's mesh those vertices only (the joints
    still come from the full model's template): ``vertex_subset_size`` n
    loads ``vertex_subset_{n}.npz`` beside the model file, decimating the
    template into it first where it is missing; ``vertex_subset`` gives the
    indices, ``faces`` the subset's triangles and ``joint_regressor_post_lbs``
    (J, n) the regressor of the joints from the subset's vertices (default:
    the full regressor's columns of the subset).
    """

    def __init__(self, model_name: str = 'smpl', gender: str = 'neutral',
                 model_root: Optional[str] = None, num_betas: Optional[int] = None,
                 vertex_subset_size: Optional[int] = None, vertex_subset=None, faces=None,
                 joint_regressor_post_lbs=None, *, device='cuda'):
        super().__init__()
        device = _model_device(device)
        data = _modeldata.initialize(model_name, gender, model_root, num_betas,
                                     vertex_subset_size, vertex_subset, faces,
                                     joint_regressor_post_lbs)
        self._init_from_data(data, model_name, gender, device)

    @classmethod
    def from_model_data(cls, data: _modeldata.ModelData, model_name: str = 'smpl',
                        gender: str = 'neutral', *, device='cuda') -> 'BodyModel':
        """Build the model from a :class:`ModelData` of numpy arrays (the
        weights carried over from the JAX package's ``BodyModel.model_data``)."""
        device = _model_device(device)
        obj = cls.__new__(cls)
        nn.Module.__init__(obj)
        obj._init_from_data(data, model_name, gender, device)
        return obj

    def _init_from_data(self, data: _modeldata.ModelData, model_name, gender, device) -> None:
        self.model_name = model_name
        self.gender = gender
        # Host copy for the fitter's numpy precompute.
        self.model_data = data
        self.kintree_parents = tuple(int(p) for p in data.kintree_parents)
        self.num_joints = data.num_joints
        self.num_vertices = data.num_vertices
        self.num_betas = int(data.shapedirs.shape[2])
        self.faces = data.faces
        self.vertex_subset = data.vertex_subset
        self.joint_names = data.joint_names

        def buf(name, x):
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device))

        for name in ('v_template', 'shapedirs', 'posedirs', 'J_regressor_post_lbs',
                     'J_template', 'J_shapedirs', 'kid_shapedir', 'kid_J_shapedir', 'weights'):
            buf(name, getattr(data, name))

        # Extended-LBS kernel operands: zero-row-padded skinning weights
        # (V_pad, J) and the component-major homogeneous template projector
        # (4, V_pad, P + 1 + S + 1) ordered [posedirs | v_template | shapedirs |
        # kid_shapedir], with a homogeneous row that is 0 except v_template's 1.
        V = data.v_template.shape[0]
        v_pad = -(-V // lbs_kernels.VC) * lbs_kernels.VC

        def pad_rows(x):
            return np.concatenate([x, np.zeros((v_pad - V,) + x.shape[1:], x.dtype)], axis=0)

        v_template4 = np.concatenate([np.asarray(data.v_template), np.ones((V, 1))], axis=1)
        posedirs4 = np.concatenate(
            [np.asarray(data.posedirs), np.zeros((V, 1, data.posedirs.shape[2]))], axis=1)
        sd4 = np.concatenate(
            [np.asarray(data.shapedirs), np.zeros((V, 1, data.shapedirs.shape[2]))], axis=1)
        kid4 = np.concatenate([np.asarray(data.kid_shapedir), np.zeros((V, 1))], axis=1)
        consts = np.concatenate(
            [posedirs4, v_template4[:, :, None], sd4, kid4[:, :, None]], axis=2)
        weights_pad = pad_rows(np.asarray(data.weights))
        buf('lbs_weights_pad', weights_pad)
        buf('lbs_consts', pad_rows(consts).transpose(1, 0, 2))
        # K1's cover of the vertices: segments of at most 32 of one body part,
        # each with its active joints (rows past V carry no weight).
        self.lbs_cover = lbs_kernels.wgram_cover(weights_pad, V, device)

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def as_f32(self, x) -> torch.Tensor:
        """An input as a float32 tensor on the model's device (numpy inputs are
        copied, so read-only arrays are fine)."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.array(x, dtype=np.float32), device=self.device)

    def forward(self, pose_rotvecs=None, shape_betas=None, trans=None, kid_factor=None,
                rel_rotmats=None, glob_rotmats=None, *, return_vertices: bool = True) -> dict:
        """Vertices (B, V, 3), joints (B, J, 3) and global orientations
        (B, J, 3, 3) for a batch of betas (B, <= S), translations (B, 3), kid
        factors (B,) and one rotation input: pose rotation vectors (B, 3J),
        parent-relative rotation matrices (B, J, 3, 3) or global ones
        (B, J, 3, 3); none means the T-pose. ``return_vertices=False`` skips
        the mesh and returns joints and orientations only."""
        with profiling.span('forward'):
            return self._forward(pose_rotvecs, shape_betas, trans, kid_factor, rel_rotmats,
                                 glob_rotmats, return_vertices)

    def _forward(self, pose_rotvecs, shape_betas, trans, kid_factor, rel_rotmats,
                 glob_rotmats, return_vertices: bool) -> dict:
        rot_inputs = [name for name, x in (('pose_rotvecs', pose_rotvecs),
                                           ('rel_rotmats', rel_rotmats),
                                           ('glob_rotmats', glob_rotmats)) if x is not None]
        if len(rot_inputs) > 1:
            raise ValueError('Only one rotation input may be provided. '
                             f'Got: {", ".join(rot_inputs)}.')
        batch_sizes = [x.shape[0] for x in (pose_rotvecs, shape_betas, trans, rel_rotmats,
                                            glob_rotmats) if x is not None]
        if not batch_sizes:
            raise ValueError('At least one argument must be given to determine the batch size.')
        if any(b != batch_sizes[0] for b in batch_sizes[1:]):
            raise ValueError('The batch sizes must be equal.')
        B = batch_sizes[0]
        J = self.num_joints
        parents = self.kintree_parents
        dev = self.device

        if pose_rotvecs is not None:
            rel = rot_ops.rotvec2mat(self.as_f32(pose_rotvecs).reshape(B, J, 3))
        elif rel_rotmats is not None:
            rel = self.as_f32(rel_rotmats)
        elif glob_rotmats is None:
            rel = torch.eye(3, device=dev).expand(B, J, 3, 3)
        if glob_rotmats is None:
            glob = fk_rotations(parents, rel)
            rel1 = rel[:, 1:]
        else:
            glob = self.as_f32(glob_rotmats)
            rel1 = rot_ops.matmul3x3(glob[:, index_tensor(parents[1:], dev)], glob[:, 1:],
                                     transpose_a=True)

        betas = (torch.zeros((B, 0), device=dev) if shape_betas is None
                 else self.as_f32(shape_betas))
        nb = min(betas.shape[1], self.num_betas)
        betas = betas[:, :nb]
        kid = (torch.zeros((1,), device=dev) if kid_factor is None
               else self.as_f32(kid_factor).reshape(-1))
        trans = (torch.zeros((1, 3), device=dev) if trans is None
                 else self.as_f32(trans))

        j = (self.J_template
             + torch.einsum('jcs,bs->bjc', self.J_shapedirs[:, :, :nb], betas)
             + torch.einsum('jc,b->bjc', self.kid_J_shapedir, kid))
        parent1 = index_tensor(parents[1:], dev)
        j_parent = torch.cat([torch.zeros_like(j[:, :1]), j[:, parent1]], dim=1)
        glob_pos = fk_positions(parents, glob, j - j_parent)
        if not return_vertices:
            return dict(joints=glob_pos + trans[:, None], orientations=glob)

        # Kernel operands: per-joint [R|t] (12, J, B) and the homogeneous
        # feature (F, B) = [pose feature; 1; betas; kid], with the projector
        # narrowed to the betas in use.
        S = self.num_betas
        base = self.posedirs.shape[2] + 1
        consts = self.lbs_consts
        if nb < S:
            consts = torch.cat([consts[:, :, :base + nb], consts[:, :, base + S:]], dim=2)
        translations = glob_pos - rot_ops.matvec3(glob, j) + trans[:, None]
        pj_cm = torch.cat([glob.expand(B, J, 3, 3), translations[..., None]], dim=3)
        pj_cm = pj_cm.permute(2, 3, 1, 0).reshape(12, J, B).contiguous()
        feat = torch.cat([
            rel1.reshape(B, (J - 1) * 9),
            torch.ones((B, 1), device=dev),
            betas,
            kid.reshape(-1, 1).expand(B, 1),
        ], dim=1).T.contiguous()
        verts_vm = lbs_kernels.lbs_points(pj_cm, feat, self.lbs_weights_pad, consts,
                                          cover=self.lbs_cover)
        return dict(
            vertices=lbs_kernels.from_vertex_major(verts_vm, self.num_vertices),
            joints=glob_pos + trans[:, None],
            orientations=glob,
        )

    def single(self, *args, return_vertices: bool = True, **kwargs) -> dict:
        """Unbatched :meth:`forward`: inputs and outputs without the batch dim."""
        args = [self.as_f32(x)[None] for x in args]
        kwargs = {k: self.as_f32(v)[None] for k, v in kwargs.items()}
        if not args and not kwargs:
            kwargs['shape_betas'] = torch.zeros((1, 0), device=self.device)
        result = self(*args, return_vertices=return_vertices, **kwargs)
        return {k: v[0] for k, v in result.items()}

    def rototranslate(self, R, t=None, pose_rotvecs=None, shape_betas=None, trans=None,
                      kid_factor=0.0, post_translate: bool = True):
        """Rotate (R (3, 3)) and translate (t (3,)) one body in parameter
        space, accounting for the pelvis offset: the new root rotation vector
        and translation for unbatched pose_rotvecs (3J,), shape_betas and
        trans (3,). Returns (new_pose_rotvecs, new_trans)."""
        if pose_rotvecs is None or shape_betas is None or trans is None:
            raise ValueError('pose_rotvecs, shape_betas, and trans are required.')
        R = self.as_f32(R)
        t = torch.zeros(3, device=self.device) if t is None else self.as_f32(t)
        pose_rotvecs = self.as_f32(pose_rotvecs)
        shape_betas = self.as_f32(shape_betas)
        trans = self.as_f32(trans)

        new_rotmat = R @ rot_ops.rotvec2mat(pose_rotvecs[:3])
        new_root = rot_ops.mat2rotvec_lm(new_rotmat.reshape(9))
        new_pose_rotvecs = torch.cat([new_root, pose_rotvecs[3:]])
        pelvis = (self.J_template[0]
                  + self.J_shapedirs[0, :, :shape_betas.shape[0]] @ shape_betas
                  + self.kid_J_shapedir[0] * kid_factor)
        eye = torch.eye(3, device=self.device)
        if post_translate:
            new_trans = pelvis @ (R.T - eye) + trans @ R.T + t
        else:
            new_trans = pelvis @ (R.T - eye) + (trans - t) @ R.T
        return new_pose_rotvecs, new_trans
