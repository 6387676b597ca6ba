"""Closed-form SMPL-family body fitting in PyTorch, ported from
``smplfitter_tpu.models.bodyfitter`` (its lane-major fit path ``_fit_lm``).

The fit alternates two closed-form solves: a per-body-part orientation fit
(Kabsch on joints, swing and twist on bones, Kabsch on vertices for leaves,
all from per-part sufficient statistics) and the moment-tensor shape and
translation solve (``shape_gram``). Rotations flow as ``(9, J, B)`` entry
arrays and 3-vectors as ``(3, J, B)``, the layouts the kernels use.

Ported here, for SMPL, SMPL-X, SMPL+H and MANO: :meth:`BodyFitter.fit` with
or without target joints, any number of iterations, optional final rotation
adjustment, warm starts, the kid factor, ``scale_target`` / ``scale_fit``,
the ``'vertices'`` / ``'joints'`` outputs, fit weights, static
(``BodyFitter(vertex_weights=, joint_weights=)``) or per call, and
``share_beta`` (one shape for the batch; ``batch_mask`` leaves padding
instances out of it); :meth:`~BodyFitter.fit_with_known_pose`,
:meth:`~BodyFitter.fit_with_known_shape` (also with a kid factor on a fitter
without the kid column) and :meth:`~BodyFitter.fit_scale_and_translation`,
weighted or not.

Fit weights follow the JAX package: the rotation fits are weighted whenever
a weight exists (ω in the part sums, joint weights in the joint Kabsch and
the final adjustment's joint term); the shape solve is weighted only under
the both-or-neither rule (with target joints both kinds, without them
vertex weights alone). Static and per-call weights do not mix.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import lbs_kernels
from ..ops import rotation as rot_ops
from ..utils import profiling
from .bodymodel import BodyModel, fk_rotations, index_tensor, tree_levels
from .shape_gram import (SHARED_FIELDS, GramData, build_gram_data, fit_shape_gram_lm,
                         fit_shape_wgram_lm, lbs_recon_spec_lm)

# ---------------------------------------------------------------------------
# Static fit plan
# ---------------------------------------------------------------------------


@dataclass
class FitterPlan:
    """Precomputed static structure and constant tensors of the fit."""

    part_counts: torch.Tensor  # (1, J, 1) vertices per part
    center_matrix: torch.Tensor  # (J, J) children-mean averaging
    mjp_joint_membership: torch.Tensor  # (n_multi, J)
    mjp_joint_counts: torch.Tensor  # (1, n_multi, 1)
    mjp_center_matrix: torch.Tensor  # (n_multi, J)
    J_template_ext: torch.Tensor  # (J, 3, 1+E) joint template + per-beta columns
    bone_ext: torch.Tensor  # (J, 3, 1+E) parent-relative extended bones
    pm_t_pad: torch.Tensor  # (J, V_pad) one-hot part membership of the used vertices
    default_mesh_vm: torch.Tensor  # (3, V_pad, 1) T-pose mesh, component-major
    part_verts: torch.Tensor  # int32: used vertices grouped by part (see PartIndex)
    part_seg_offset: torch.Tensor  # int32 (n_seg + 1,)
    part_seg: torch.Tensor  # int32 (J + 1,)
    part_of_vertex: torch.Tensor  # int32 (V_pad,): each vertex's part, -1 for none
    part_seg_joints: torch.Tensor  # int32: each segment's active joints (K6's blend)
    part_seg_joint_offset: torch.Tensor  # int32 (n_seg + 1,)
    part_tile_offset: torch.Tensor  # int32 (n_tiles + 1,): K14's 32-vertex tiles of the segments
    part_tile_seg: torch.Tensor  # int32 (n_tiles,)
    part_unused: torch.Tensor  # int32: the vertices below V_pad in no part

    bone_parts: tuple
    leaf_parts: tuple
    bone_pairs: tuple  # ((j0, j1), ...)
    assemble_indices: tuple
    children_and_self: tuple
    is_smpl_family: bool
    n_betas: int
    enable_kid: bool
    # Final-adjustment schedule: entry 0 is the root, entry k+1 the k-th tree
    # level; each entry groups its adjustable parts into buckets of equal
    # joint count, so every bucket refines as one batched step.
    adj_level_buckets: tuple
    # Static fit weights ω (None: unweighted): they weight every part sum.
    omega_pad: Optional[torch.Tensor] = None  # (V_pad, 1), zero rows in the padding
    part_counts_w: Optional[torch.Tensor] = None  # (1, J, 1) sum of ω per part

    @property
    def parts(self) -> lbs_kernels.PartIndex:
        return lbs_kernels.PartIndex(pm=self.pm_t_pad, verts=self.part_verts,
                                     seg_offset=self.part_seg_offset, part_seg=self.part_seg,
                                     vpart=self.part_of_vertex, joints=self.part_seg_joints,
                                     joint_offset=self.part_seg_joint_offset,
                                     tile_offset=self.part_tile_offset,
                                     tile_seg=self.part_tile_seg, unused=self.part_unused)


def build_plan(bm: BodyModel, enable_kid: bool = False, num_betas: Optional[int] = None,
               device='cpu', vertex_weights: Optional[np.ndarray] = None) -> FitterPlan:
    """Host-side (numpy) construction of the static fit plan, in canonical
    vertex order; ``enable_kid`` appends the kid column to the extended joint
    template; static ``vertex_weights`` (V,) add ``omega_pad`` and the
    weighted part counts."""
    data = bm.model_data
    weights = np.asarray(data.weights)
    parents = bm.kintree_parents
    J = bm.num_joints
    V = bm.num_vertices
    n_betas = bm.num_betas if num_betas is None else min(num_betas, bm.num_betas)
    is_smpl_family = bm.model_name.startswith('smpl')

    part_assignment = np.argmax(weights, axis=1)
    if is_smpl_family:
        # Toe parts copy the feet: their vertices are folded into the foot parts.
        part_assignment = np.where(part_assignment == 10, 7, part_assignment)
        part_assignment = np.where(part_assignment == 11, 8, part_assignment)

    children_and_self = [[i] for i in range(J)]
    for i in range(1, J):
        children_and_self[parents[i]].append(i)

    # Bucket parts by joint count: >=3 Kabsch on joints, ==2 swing+twist bone,
    # ==1 Kabsch on vertices. SMPL toes (10, 11) are excluded (copy feet).
    multi_joint_parts, bone_parts, leaf_parts = [], [], []
    for i in range(J):
        if is_smpl_family and i in (10, 11):
            continue
        n = len(children_and_self[i])
        if n >= 3:
            multi_joint_parts.append(i)
        elif n == 2:
            bone_parts.append(i)
        else:
            leaf_parts.append(i)

    adjustable_parts = (
        [1, 2, 4, 5, 7, 8, 16, 17, 18, 19] if is_smpl_family else list(range(J))
    )

    stat_parts = sorted(set(bone_parts + leaf_parts + adjustable_parts))
    used_mask = np.zeros(V, dtype=bool)
    for i in stat_parts:
        used_mask[part_assignment == i] = True
    used_vertex_indices = np.where(used_mask)[0]

    # Full-V membership, zero columns for unused vertices and padding.
    v_pad = -(-V // lbs_kernels.VC) * lbs_kernels.VC
    pm_t_pad = np.zeros((J, v_pad), dtype=np.float32)
    pm_t_pad[part_assignment[used_vertex_indices], used_vertex_indices] = 1.0

    center_matrix = np.zeros((J, J), dtype=np.float32)
    for i in range(J):
        js = children_and_self[i]
        center_matrix[i, js] = 1.0 / len(js)

    mjp_joint_membership = np.zeros((len(multi_joint_parts), J), dtype=np.float32)
    for k, i in enumerate(multi_joint_parts):
        mjp_joint_membership[k, children_and_self[i]] = 1.0

    bone_pairs = tuple(
        (children_and_self[i][0], children_and_self[i][1]) for i in bone_parts
    )

    # R_concat = [R_multi, R_leaf, R_bone] scattered back to per-part order;
    # SMPL toes take the feet slots.
    concat_order = multi_joint_parts + leaf_parts + bone_parts
    inverse_perm = [0] * J
    for pos, jj in enumerate(concat_order):
        inverse_perm[jj] = pos
    if is_smpl_family:
        inverse_perm[10] = inverse_perm[7]
        inverse_perm[11] = inverse_perm[8]

    # Extended joint template: position column + per-beta columns (+ kid column).
    J_template = np.asarray(data.J_template, np.float64)
    J_shapedirs = np.asarray(data.J_shapedirs, np.float64)[:, :, :n_betas]
    cols = [J_template.reshape(J, 3, 1), J_shapedirs]
    if enable_kid:
        cols.append(np.asarray(data.kid_J_shapedir, np.float64).reshape(J, 3, 1))
    J_template_ext = np.concatenate(cols, axis=2)
    bone_ext = J_template_ext - J_template_ext[[0] + list(parents[1:])]

    # T-pose mesh: with identity rotations the pose feature exactly cancels
    # the loader's zero-point shift.
    eye_feat = np.tile(np.eye(3), (J - 1, 1)).reshape(-1)
    default_mesh = (np.asarray(data.v_template, np.float64)
                    + np.asarray(data.posedirs, np.float64) @ eye_feat)

    levels = tree_levels(parents)
    adjustable_set = set(adjustable_parts)

    def _buckets(parts):
        by_count: dict[int, list] = {}
        for i in parts:
            by_count.setdefault(len(children_and_self[i]), []).append(i)
        return tuple(tuple(v) for _, v in sorted(by_count.items()))

    adj_level_buckets = tuple(
        _buckets([i for i in lvl if i in adjustable_set]) for lvl in [[0], *levels]
    )

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    parts = lbs_kernels.PartIndex.from_membership(pm_t_pad, device, weights=weights)
    omega = None if vertex_weights is None else np.asarray(vertex_weights, np.float64).reshape(V)
    return FitterPlan(
        omega_pad=None if omega is None else f32(np.pad(omega.reshape(V, 1),
                                                        ((0, v_pad - V), (0, 0)))),
        part_counts_w=None if omega is None else f32((pm_t_pad[:, :V] @ omega).reshape(1, J, 1)),
        part_counts=f32(pm_t_pad.sum(axis=1).reshape(1, J, 1)),
        center_matrix=f32(center_matrix),
        mjp_joint_membership=f32(mjp_joint_membership),
        mjp_joint_counts=f32(mjp_joint_membership.sum(axis=1).reshape(1, -1, 1)),
        mjp_center_matrix=f32(center_matrix[multi_joint_parts]),
        J_template_ext=f32(J_template_ext),
        bone_ext=f32(bone_ext),
        pm_t_pad=parts.pm,
        default_mesh_vm=f32(
            np.pad(default_mesh.T[:, :, None], ((0, 0), (0, v_pad - V), (0, 0)))),
        part_verts=parts.verts,
        part_seg_offset=parts.seg_offset,
        part_seg=parts.part_seg,
        part_of_vertex=parts.vpart,
        part_seg_joints=parts.joints,
        part_seg_joint_offset=parts.joint_offset,
        part_tile_offset=parts.tile_offset,
        part_tile_seg=parts.tile_seg,
        part_unused=parts.unused,
        bone_parts=tuple(bone_parts),
        leaf_parts=tuple(leaf_parts),
        bone_pairs=bone_pairs,
        assemble_indices=tuple(inverse_perm),
        children_and_self=tuple(tuple(c) for c in children_and_self),
        is_smpl_family=is_smpl_family,
        n_betas=n_betas,
        enable_kid=enable_kid,
        adj_level_buckets=adj_level_buckets,
    )


# ---------------------------------------------------------------------------
# Lane-major fit pipeline
# ---------------------------------------------------------------------------


def _center_targets(target_vertices, target_joints, full_mean: bool = False):
    """Shift targets to a body-centred origin (f32 conditioning of the raw part
    moments); the fit adds the mean back to the translation. The joints' mean
    when joints are given, else the vertices'; ``full_mean`` takes the mean of
    vertices and joints together, which the scale fits need (their
    translation does not shift with slope 1 in the centre)."""
    if target_joints is None:
        target_mean = target_vertices.mean(dim=1)
        return target_vertices - target_mean[:, None], None, target_mean
    if full_mean:
        target_mean = ((target_vertices.sum(dim=1) + target_joints.sum(dim=1))
                       / (target_vertices.shape[1] + target_joints.shape[1]))
    else:
        target_mean = target_joints.mean(dim=1)
    return (target_vertices - target_mean[:, None],
            target_joints - target_mean[:, None], target_mean)


def _regress_joints_lm(bm, vertices_vm):
    """Joints (3, J, B) regressed from a component-major mesh (3, >= V, B)."""
    return torch.einsum('jv,cvb->cjb', bm.J_regressor_post_lbs,
                        vertices_vm[:, :bm.num_vertices])


def fit_scale_and_translation(target_vertices, reference_vertices, target_joints=None,
                              reference_joints=None, vertex_weights=None, joint_weights=None,
                              scale: bool = False):
    """Weighted Procrustes scale and translation (no rotation) that align the
    reference points (B, V, 3) [+ joints (B, J, 3)] onto the targets: (scale
    or None, trans (B, 3)). Joints count only when both kinds of points are
    given; with them, the weights (B, V) and (B, J) count only when both are
    given, without them the vertex weights alone."""
    if target_joints is None or reference_joints is None:
        target_both, reference_both = target_vertices, reference_vertices
        weights_both = vertex_weights
    else:
        target_both = torch.cat([target_vertices, target_joints], dim=1)
        reference_both = torch.cat([reference_vertices, reference_joints], dim=1)
        weights_both = (None if vertex_weights is None or joint_weights is None
                        else torch.cat([vertex_weights, joint_weights], dim=1))
    if weights_both is None:
        mean_t = target_both.mean(dim=1)
        mean_r = reference_both.mean(dim=1)
    else:
        weights_both = (weights_both / weights_both.sum(dim=1, keepdim=True))[..., None]
        mean_t = (target_both * weights_both).sum(dim=1)
        mean_r = (reference_both * weights_both).sum(dim=1)
    if not scale:
        return None, mean_t - mean_r
    sq_t = (target_both - mean_t[:, None]) ** 2
    sq_r = (reference_both - mean_r[:, None]) ** 2
    if weights_both is not None:
        sq_t, sq_r = sq_t * weights_both, sq_r * weights_both
    scale_factor = torch.sqrt(sq_t.sum(dim=(1, 2)) / sq_r.sum(dim=(1, 2)))
    return scale_factor, mean_t - scale_factor[:, None] * mean_r


def _lm_rotation_formats(bm, result, glob9, requested_keys) -> None:
    """Relative orientations / pose rotvecs from lane-major globals."""
    if 'relative_orientations' not in requested_keys and 'pose_rotvecs' not in requested_keys:
        return
    dev = glob9.device
    eye_col = torch.eye(3, device=dev).reshape(9, 1, 1).expand(9, 1, glob9.shape[2])
    parents9 = glob9[:, index_tensor(bm.kintree_parents[1:], dev)]
    parent9 = torch.cat([eye_col, parents9], dim=1)
    rel9 = rot_ops.matmul3x3_lm(parent9, glob9, transpose_a=True)
    result['relative_orientations'] = rel9.permute(2, 1, 0).reshape(-1, bm.num_joints, 3, 3)
    if 'pose_rotvecs' in requested_keys:
        rv = rot_ops.mat2rotvec_lm(rel9)  # (3, J, B)
        result['pose_rotvecs'] = rv.permute(2, 1, 0).reshape(glob9.shape[2], -1)


def _centered_cov_lm(raw9, s_t, s_a, s_w, c_t, c_a):
    """Centered cross-covariance: raw9 (9, n, B) rows (c, d); s_t/c_t
    (3, n, B); s_a/c_a (3, n, B|1); s_w (n, 1|B)."""
    return torch.stack([
        raw9[c * 3 + d] - s_t[c] * c_a[d] - c_t[c] * s_a[d] + s_w * (c_t[c] * c_a[d])
        for c in range(3) for d in range(3)
    ])


def _part_sums_static_ref_lm(plan: FitterPlan, target_vm, reference_vm):
    """Per-part sums against a batch-constant reference (3, V_pad, 1) as ONE
    GEMM in full f32: raw[(c,d), j, b] = sum_v (pm_jv ref_dv) tgt_cvb and
    s_t[c, j, b] = sum_v pm_jv tgt_cvb share a (4J, V) x (3, V, B) product.
    A static ω column folds into the membership rows."""
    J = plan.pm_t_pad.shape[0]
    v_t = target_vm.shape[1]
    pm = plan.pm_t_pad[:, :v_t]
    if plan.omega_pad is not None:
        pm = pm * plan.omega_pad[:v_t].T
    ref = reference_vm[:, :v_t, 0]  # (3, V)
    lhs = torch.cat([(pm[None] * ref[:, None]).reshape(3 * J, v_t), pm], dim=0)
    out = torch.matmul(lhs, target_vm)  # (3, 4J, B)
    raw = torch.stack([out[c, d * J:(d + 1) * J] for c in range(3) for d in range(3)])
    s_t = out[:, 3 * J:]
    s_a = torch.einsum('jv,dv->dj', pm, ref)[:, :, None]
    return raw, s_t, s_a


def part_sums_lm(plan: FitterPlan, target_vm, reference_vm=None, reference_spec=None,
                 omega=None):
    """Per-part sums raw (9, J, B), s_t (3, J, B), s_a (3, J, B|1), s_w (J, 1|B)
    of the targets against one of: the operands of a fitted mesh
    (``reference_spec``: K4 from the posed-template cache when the shape solve
    made one, else K6), a batch-constant mesh (``reference_vm`` (3, V_pad, 1):
    one GEMM, or K5 under per-call weights) or a per-instance mesh
    (``reference_vm`` (3, V_pad, B): K5). A statically weighted plan weights
    every sum by its ω column; per-call weights ``omega`` (V, B) take its
    place and make s_w vary over the batch."""
    om = plan.omega_pad if omega is None else omega
    w = {} if om is None else dict(omega=om)
    if reference_spec is not None:
        if reference_spec['homog_vm'] is not None:
            raw, s_t, s_a = lbs_kernels.recon_part_sums_cached_lm(
                target_vm, reference_spec['pj_cm'], reference_spec['x_cols'],
                reference_spec['sd_cm'], reference_spec['homog_vm'], plan.parts,
                reference_spec['weights_pad'], **w)
        else:
            raw, s_t, s_a = lbs_kernels.recon_part_sums_lm(
                target_vm, reference_spec['pj_cm'], reference_spec['feat_cols'],
                reference_spec['weights_pad'], reference_spec['consts_pad'], plan.parts, **w)
    elif reference_vm.shape[2] == 1 and omega is None:
        raw, s_t, s_a = _part_sums_static_ref_lm(plan, target_vm, reference_vm)
    else:
        raw, s_t, s_a = lbs_kernels.part_sums_vm_lm(target_vm, reference_vm, plan.parts, **w)
    if omega is not None:
        return raw, s_t, s_a, torch.matmul(plan.pm_t_pad[:, :omega.shape[0]], omega)
    counts = plan.part_counts if plan.omega_pad is None else plan.part_counts_w
    return raw, s_t, s_a, counts[0]


def fit_global_rotations_lm(bm, plan: FitterPlan, tgt_vm, tj_lm, reference_vm, rj_lm,
                            reference_spec=None, jw_lm=None, omega=None):
    """Per-part orientation fit; tj_lm/rj_lm (3, J, B|1), or None to regress
    both from the meshes; joint weights ``jw_lm`` (J, B) and per-call vertex
    weights ``omega`` (V, B), or None."""
    if tj_lm is None or rj_lm is None:
        tj_lm = _regress_joints_lm(bm, tgt_vm)
        rj_lm = _regress_joints_lm(bm, reference_vm)
    raw, s_t, s_a, s_w = part_sums_lm(plan, tgt_vm, reference_vm, reference_spec, omega)
    return _fit_rotations_core_lm(plan, raw, s_t, s_a, s_w, tj_lm, rj_lm, jw_lm)


def _spec_points(spec):
    """The mesh (3, V_pad, B) of a reconstruction spec, by K1 on its cover."""
    return lbs_kernels.lbs_points(spec['pj_cm'], spec['feat_cols'], spec['weights_pad'],
                                  spec['consts_pad'], cover=spec['cover'])


def fit_rotations_to_spec_lm(bm, plan: FitterPlan, tgt_vm, tj_lm, spec, rj_lm, jw_lm=None,
                             omega=None):
    """Orientation fit against a known shape's reconstruction spec (see
    ``shape_gram.lbs_recon_spec_lm``) with model joints rj_lm: through K6 with
    target joints; without, the mesh is made (K1) to regress joints from."""
    if tj_lm is not None:
        return fit_global_rotations_lm(bm, plan, tgt_vm, tj_lm, None, rj_lm,
                                       reference_spec=spec, jw_lm=jw_lm, omega=omega)
    return fit_global_rotations_lm(bm, plan, tgt_vm, None, _spec_points(spec), None,
                                   jw_lm=jw_lm, omega=omega)


def _fit_rotations_core_lm(plan: FitterPlan, raw, s_t, s_a, s_w, tj_lm, rj_lm, jw_lm=None):
    """Covariance assembly and bucketed projections of the orientation fit;
    joint weights ``jw_lm`` (J, B) weight the joint Kabsch of the
    multi-joint parts."""
    dev = raw.device
    mt = torch.einsum('jk,ckb->cjb', plan.center_matrix, tj_lm)
    ma = torch.einsum('jk,ckb->cjb', plan.center_matrix, rj_lm)
    A_vert = _centered_cov_lm(raw, s_t, s_a, s_w, mt, ma)  # (9, J, B)

    if jw_lm is None:
        rj_w, tj_side = rj_lm, tj_lm
        s_wj = plan.mjp_joint_counts[0]  # (n_multi, 1)
    else:
        rj_w, tj_side = rj_lm * jw_lm[None], tj_lm * jw_lm[None]
        s_wj = torch.matmul(plan.mjp_joint_membership, jw_lm)  # (n_multi, B)
    outer9 = torch.stack([tj_lm[c] * rj_w[d] for c in range(3) for d in range(3)])
    raw_j = torch.einsum('mj,xjb->xmb', plan.mjp_joint_membership, outer9)
    mtj = torch.einsum('mj,cjb->cmb', plan.mjp_center_matrix, tj_lm)
    maj = torch.einsum('mj,cjb->cmb', plan.mjp_center_matrix, rj_lm)
    s_tj = torch.einsum('mj,cjb->cmb', plan.mjp_joint_membership, tj_side)
    s_aj = torch.einsum('mj,cjb->cmb', plan.mjp_joint_membership, rj_w)
    A_multi = _centered_cov_lm(raw_j, s_tj, s_aj, s_wj, mtj, maj)

    A_kabsch = torch.cat([A_multi, A_vert[:, index_tensor(plan.leaf_parts, dev)]], dim=1)
    R_kabsch = rot_ops.proj_SO3_lm(A_kabsch)

    bp = np.array(plan.bone_pairs, dtype=np.int64).reshape(-1, 2)
    i0, i1 = index_tensor(bp[:, 0], dev), index_tensor(bp[:, 1], dev)
    b_ref = rj_lm[:, i1] - rj_lm[:, i0]
    b_tgt = tj_lm[:, i1] - tj_lm[:, i0]

    def _norm3(v):
        return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])

    b_ref_n = rot_ops.divide_no_nan(b_ref, _norm3(b_ref)[None])
    b_tgt_n = rot_ops.divide_no_nan(b_tgt, _norm3(b_tgt)[None])
    R_swing = rot_ops.align_unit_vectors_lm(b_ref_n, b_tgt_n)

    A_bone = A_vert[:, index_tensor(plan.bone_parts, dev)]
    H = rot_ops.matmul3x3_lm(R_swing, A_bone, transpose_b=True)
    trH = H[0] + H[4] + H[8]
    bHb = sum(b_tgt_n[i] * H[i * 3 + j] * b_tgt_n[j] for i in range(3) for j in range(3))
    vee = (H[5] - H[7], H[6] - H[2], H[1] - H[3])
    twist_angle = torch.atan2(sum(b_tgt_n[i] * vee[i] for i in range(3)), trH - bHb)
    R_twist = rot_ops.rotvec2mat_lm(b_tgt_n * twist_angle[None])
    R_bone = rot_ops.matmul3x3_lm(R_twist, R_swing)

    R_concat = torch.cat([R_kabsch, R_bone], dim=1)
    return R_concat[:, index_tensor(plan.assemble_indices, dev)]


def fk_positions_ext_lm(bm, plan: FitterPlan, glob_lm):
    """Level-batched FK of the extended joint positions: (3, 1+E, J, B).
    Column 0 is the position, columns 1.. its derivatives by the betas."""
    dev = glob_lm.device
    batch = glob_lm.shape[2]
    parents = bm.kintree_parents
    bone_lm = plan.bone_ext.permute(1, 2, 0)[:, :, :, None]  # (3, n_ext, J, 1)
    n_ext = bone_lm.shape[1]
    pos = torch.empty((3, n_ext, bm.num_joints, batch), device=dev)
    pos[:, :, 0] = plan.J_template_ext[0][:, :, None]
    for level in tree_levels(parents):
        js = index_tensor(level, dev)
        ps = index_tensor([parents[i] for i in level], dev)
        rot_p = glob_lm[:, ps]  # (9, n_lvl, B)
        bone_j = bone_lm[:, :, js]  # (3, n_ext, n_lvl, 1)
        rotated = torch.stack([
            sum(rot_p[a * 3 + c][None] * bone_j[c] for c in range(3)) for a in range(3)
        ])  # (3, n_ext, n_lvl, B): parent rotation applied to the child bone
        pos[:, :, js] = pos[:, :, ps] + rotated
    return pos


def fit_global_rotations_dependent_lm(bm, plan: FitterPlan, tgt_vm, tj_lm, reference_vm, rj_lm,
                                      glob9_prev, shape_betas, trans_lm, kid_factor=None,
                                      reference_spec=None, scale_corr=None, jw_lm=None,
                                      omega=None):
    """Final rotation adjustment against the shape solve's reconstruction.
    The parts are re-anchored at the solved model joints ``rj_lm`` even where
    the working joints are regressed from the meshes (no target joints);
    ``scale_corr`` (B,) scales the model joints of the tree walk; ``jw_lm``
    and ``omega`` as in :func:`fit_global_rotations_lm`."""
    true_rj_lm = rj_lm
    if tj_lm is None or rj_lm is None:
        tj_lm = _regress_joints_lm(bm, tgt_vm)
        rj_lm = _regress_joints_lm(bm, reference_vm)
    if true_rj_lm is None:
        true_rj_lm = rj_lm
    raw, s_t, s_a, s_w = part_sums_lm(plan, tgt_vm, reference_vm, reference_spec, omega)
    return _fit_rotations_dependent_core_lm(bm, plan, raw, s_t, s_a, s_w, tj_lm, rj_lm,
                                            true_rj_lm, glob9_prev, shape_betas, trans_lm,
                                            kid_factor, scale_corr, jw_lm)


def _fit_rotations_dependent_core_lm(bm, plan: FitterPlan, raw, s_t, s_a, s_w, tj_lm, rj_lm,
                                     true_rj_lm, glob9_prev, shape_betas, trans_lm,
                                     kid_factor=None, scale_corr=None, jw_lm=None):
    """Bucket-batched tree walk of the final rotation adjustment: FK one tree
    level at a time from the solved shape's bones, then refine that level's
    adjustable parts in equal-joint-count buckets, each re-anchored at its
    recomputed proximal joint, one batched projection per bucket. Joint
    weights ``jw_lm`` (J, B) weight the joint term."""
    dev = raw.device
    n_betas = plan.n_betas
    batch = glob9_prev.shape[2]
    parents = bm.kintree_parents
    j_lm = (torch.einsum('jcs,bs->cjb', bm.J_shapedirs[:, :, :n_betas], shape_betas[:, :n_betas])
            + bm.J_template.T[:, :, None])
    if kid_factor is not None:
        j_lm = j_lm + torch.einsum('jc,b->cjb', bm.kid_J_shapedir, kid_factor)
    if scale_corr is not None:
        j_lm = j_lm * scale_corr[None, None, :]
    j_parent = torch.cat(
        [torch.zeros_like(j_lm[:, :1]), j_lm[:, index_tensor(parents[1:], dev)]], dim=1)
    bones = j_lm - j_parent  # (3, J, B)

    rots9 = glob9_prev.clone()
    positions = torch.zeros((3, bm.num_joints, batch), device=dev)
    positions[:, 0] = j_lm[:, 0] + trans_lm

    def refine_parts(adj):
        adj_i = index_tensor(adj, dev)
        c_t = positions[:, adj_i]
        c_a = true_rj_lm[:, adj_i]
        A_vert = _centered_cov_lm(raw[:, adj_i], s_t[:, adj_i], s_a[:, adj_i], s_w[adj_i],
                                  c_t, c_a)
        joint_sel = np.array([plan.children_and_self[i] for i in adj], dtype=np.int64)
        n, k = joint_sel.shape
        sel = index_tensor(joint_sel.reshape(-1), dev)
        estim = tj_lm[:, sel].reshape(3, n, k, batch) - c_t[:, :, None]
        default = rj_lm[:, sel].reshape(3, n, k, -1) - c_a[:, :, None]
        if jw_lm is not None:
            default = default * jw_lm[sel].reshape(n, k, -1)[None]
        A_joint = torch.stack([
            (estim[a] * default[c]).sum(dim=1) for a in range(3) for c in range(3)
        ])
        new9 = rot_ops.matmul3x3_lm(rot_ops.proj_SO3_lm(A_vert + A_joint), glob9_prev[:, adj_i])
        rots9[:, adj_i] = new9

    buckets = plan.adj_level_buckets
    last_entry = max((k for k, lvl in enumerate(buckets) if lvl), default=-1)
    for bucket in buckets[0]:  # the root
        refine_parts(bucket)
    for k, level in enumerate(tree_levels(parents)):
        if k + 1 > last_entry:
            break
        js = index_tensor(level, dev)
        ps = index_tensor([parents[i] for i in level], dev)
        rot_p = rots9[:, ps]
        bone_j = bones[:, js]
        rotated = torch.stack([
            sum(rot_p[a * 3 + c] * bone_j[c] for c in range(3)) for a in range(3)
        ])
        positions[:, js] = positions[:, ps] + rotated
        for bucket in buckets[k + 1]:
            refine_parts(bucket)
    if plan.is_smpl_family:
        rots9[:, index_tensor((10, 11), dev)] = rots9[:, index_tensor((7, 8), dev)]
    return rots9


# ---------------------------------------------------------------------------
# The parity gate: one fit against another
# ---------------------------------------------------------------------------

GATE_KEYS = ('shape_betas', 'kid_factor', 'scale_corr')


def max_param_gap(a: dict, b: dict) -> float:
    """max |a - b| over the shape parameters of two fit results (betas, and
    the kid factor and scale where the fit has them), on any devices."""
    return max((a[k].detach().cpu() - b[k].detach().cpu()).abs().max().item()
               for k in GATE_KEYS if k in a)


def recon_v2v_mm(bm: BodyModel, res: dict, tv: torch.Tensor) -> float:
    """Mean distance (mm) from ``bm``'s reconstruction of a fit result (its
    global orientations, betas, translation and kid factor) to the targets
    ``tv`` (B, V, 3) on ``tv``'s device."""
    dev = tv.device
    kid = res.get('kid_factor')
    re = bm(glob_rotmats=res['orientations'].to(dev), shape_betas=res['shape_betas'].to(dev),
            trans=res['trans'].to(dev), kid_factor=None if kid is None else kid.to(dev))
    return (re['vertices'] - tv).norm(dim=-1).mean().item() * 1e3


def parity_targets(fitter, batch: int = 32, seed: int = 0):
    """The targets (B, V, 3), (B, J, 3) of :meth:`BodyFitter.check_kernel_parity`:
    the fitter's model posed by pose N(0, 0.3), betas N(0, 1) and translation
    N(0, 0.5) from ``numpy.random.default_rng(seed)``."""
    bm = fitter.body_model
    rng = np.random.default_rng(seed)
    pose = rng.normal(0, 0.3, (batch, bm.num_joints * 3)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, fitter.n_betas)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    res = bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    return res['vertices'], res['joints']


def _runs_kernels(bm: BodyModel) -> bool:
    """Whether the wrappers launch kernels on ``bm``'s tensors (on a CUDA device)."""
    return bm.device.type == 'cuda'


def parity_gate(bm: BodyModel, ours: dict, ref: dict, tv: torch.Tensor, betas_atol: float,
                v2v_atol_mm: float) -> dict:
    """Hold a fit result ``ours`` to ``ref`` of the same targets ``tv``:
    max|d betas, kid, scale| within ``betas_atol`` and their mean
    reconstruction errors (by ``bm``) within ``v2v_atol_mm`` of each other.
    Returns ``dict(ok, max_dbetas, v2v_kernel_mm, v2v_xla_mm)``, ``ours``
    being the kernels' result and ``ref`` the reference's."""
    max_d = max_param_gap(ours, ref)
    v2v_ours, v2v_ref = recon_v2v_mm(bm, ours, tv), recon_v2v_mm(bm, ref, tv)
    ok = max_d <= betas_atol and abs(v2v_ours - v2v_ref) <= v2v_atol_mm
    return dict(ok=ok, max_dbetas=max_d, v2v_kernel_mm=v2v_ours, v2v_xla_mm=v2v_ref)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class BodyFitter(nn.Module):
    """Fits pose, shape and translation (and optionally kid factor and scale)
    to target vertices and optionally joints.

    The plan and the shape-solve operands are precomputed on the host at
    construction and kept as buffers on the body model's device.

    ``vertex_weights`` (V,) and ``joint_weights`` (J,) are static fit
    weights: the same as passing them, broadcast over the batch, to every
    call, but baked into the moments, so the solve keeps the unweighted
    kernels' route (K2's ω form, K3 / K8). A fitter with static weights
    takes no per-call weights.
    """

    def __init__(self, body_model: BodyModel, enable_kid: bool = False,
                 num_betas: Optional[int] = None, vertex_weights=None, joint_weights=None):
        super().__init__()
        self.body_model = body_model
        self.enable_kid = enable_kid
        self.static_vw = (None if vertex_weights is None
                          else np.asarray(vertex_weights, np.float32).reshape(-1))
        self.static_jw = (None if joint_weights is None
                          else np.asarray(joint_weights, np.float32).reshape(-1))
        if self.static_vw is not None and self.static_vw.shape[0] != body_model.num_vertices:
            raise ValueError(
                f'static vertex_weights must have shape ({body_model.num_vertices},)')
        if self.static_jw is not None and self.static_jw.shape[0] != body_model.num_joints:
            raise ValueError(f'static joint_weights must have shape ({body_model.num_joints},)')
        dev = body_model.device
        plan = build_plan(body_model, enable_kid, num_betas, device=dev,
                          vertex_weights=self.static_vw)
        data = body_model.model_data
        gram_args = (data.weights, data.shapedirs, data.kid_shapedir if enable_kid else None,
                     plan.n_betas, data.v_template, data.posedirs)
        gram = build_gram_data(*gram_args, device=dev)
        self._static = {}
        views = [('plan', plan), ('gram', gram)]
        if self.static_vw is not None:
            # The weighted moments; the per-vertex operands stay gram's buffers.
            views.append(('gram_w', build_gram_data(*gram_args, device=dev,
                                                    vertex_weights=self.static_vw,
                                                    shared=gram)))
        for prefix, obj in views:
            for f in dataclasses.fields(obj):
                value = getattr(obj, f.name)
                if prefix == 'gram_w' and f.name in SHARED_FIELDS:
                    continue
                if isinstance(value, torch.Tensor):
                    self.register_buffer(f'{prefix}_{f.name}', value, persistent=False)
                else:
                    self._static[prefix, f.name] = value
        if self.static_jw is not None:
            self.register_buffer('static_jw_t', torch.as_tensor(self.static_jw, device=dev),
                                 persistent=False)
        self.n_betas = plan.n_betas

    def _view(self, prefix, cls):
        def field(name):
            if (prefix, name) in self._static:
                return self._static[prefix, name]
            if prefix == 'gram_w' and name in SHARED_FIELDS:
                return getattr(self, f'gram_{name}')
            return getattr(self, f'{prefix}_{name}')
        return cls(**{f.name: field(f.name) for f in dataclasses.fields(cls)})

    @property
    def plan(self) -> FitterPlan:
        return self._view('plan', FitterPlan)

    @property
    def gram(self) -> GramData:
        return self._view('gram', GramData)

    @property
    def gram_w(self) -> Optional[GramData]:
        """The statically weighted moments, or None without static vertex weights."""
        return None if self.static_vw is None else self._view('gram_w', GramData)

    def _optional(self, x):
        return None if x is None else self.body_model.as_f32(x)

    @staticmethod
    def _solve_weighted(has_joints: bool, vertex_weights, joint_weights) -> bool:
        """The both-or-neither rule of the shape solve: with target joints it
        is weighted only when both kinds of weights exist; without joints,
        vertex weights alone weight it."""
        return vertex_weights is not None and (not has_joints or joint_weights is not None)

    def _lm_solve_weights(self, has_joints: bool):
        """The GramData and static joint weights (J,) or None of an unweighted
        call's shape solve under this fitter's static weights."""
        use_w = self._solve_weighted(has_joints, self.static_vw, self.static_jw)
        gram = self.gram_w if use_w else self.gram
        return gram, (self.static_jw_t if use_w and has_joints else None)

    def _call_weights(self, vertex_weights, joint_weights, batch: int):
        """Per-call weights as lane-major operands: omega (V, B) and jw (J, B)
        (each None when not given), checked against the model; a fitter's
        static joint weights stand in for absent per-call ones in jw."""
        if (self.static_vw is not None or self.static_jw is not None) and (
                vertex_weights is not None or joint_weights is not None):
            raise ValueError(
                'this fitter was constructed with static vertex/joint weights; per-call '
                'weights cannot be combined with them: construct an unweighted BodyFitter '
                'for per-call weighting')
        bm = self.body_model
        omega_vm = jw_lm = None
        if vertex_weights is not None:
            vertex_weights = bm.as_f32(vertex_weights)
            if tuple(vertex_weights.shape) != (batch, bm.num_vertices):
                raise ValueError(f'vertex_weights must have shape ({batch}, {bm.num_vertices}), '
                                 f'got {tuple(vertex_weights.shape)}')
            omega_vm = vertex_weights.T.contiguous()
        if joint_weights is not None:
            joint_weights = bm.as_f32(joint_weights)
            if tuple(joint_weights.shape) != (batch, bm.num_joints):
                raise ValueError(f'joint_weights must have shape ({batch}, {bm.num_joints}), '
                                 f'got {tuple(joint_weights.shape)}')
            jw_lm = joint_weights.T.contiguous()
        elif self.static_jw is not None:
            jw_lm = self.static_jw_t[:, None].expand(bm.num_joints, batch)
        return omega_vm, jw_lm

    def _batch_mask(self, batch_mask, batch: int):
        """``batch_mask`` (B,) as a float32 tensor on the model's device, or None."""
        if batch_mask is None:
            return None
        batch_mask = self.body_model.as_f32(batch_mask)
        if tuple(batch_mask.shape) != (batch,):
            raise ValueError(f'batch_mask must have shape ({batch},), '
                             f'got {tuple(batch_mask.shape)}')
        return batch_mask

    def _glob9_from_pose(self, pose_rotvecs, batch: int) -> torch.Tensor:
        """Global rotations (9, J, B) of pose rotation vectors (B, 3J), or the
        T-pose for None."""
        J = self.body_model.num_joints
        if pose_rotvecs is None:
            eye = torch.eye(3, device=self.body_model.device).reshape(9, 1, 1)
            return eye.expand(9, J, batch).contiguous()
        rel = rot_ops.rotvec2mat(self._optional(pose_rotvecs).reshape(batch, J, 3))
        glob = fk_rotations(self.body_model.kintree_parents, rel)
        return glob.reshape(batch, J, 9).permute(2, 1, 0).contiguous()

    def _shape_cols(self, shape_betas, kid_factor, batch: int) -> torch.Tensor:
        """Shape columns (B, E): betas cut or zero-padded to n_betas, then the
        kid factor (zero when None) when the plan has the kid column."""
        x = torch.zeros((batch, self.n_betas), device=self.body_model.device)
        if shape_betas is not None:
            given = shape_betas[:, :self.n_betas]
            x[:, :given.shape[1]] = given
        if self.enable_kid:
            kid = (torch.zeros((batch, 1), device=x.device) if kid_factor is None
                   else kid_factor.reshape(batch, 1))
            x = torch.cat([x, kid], dim=1)
        return x

    def fit(
        self,
        target_vertices,
        target_joints=None,
        vertex_weights=None,
        joint_weights=None,
        num_iter: int = 1,
        beta_regularizer: float = 1.0,
        beta_regularizer2: float = 0.0,
        scale_regularizer: float = 0.0,
        kid_regularizer: Optional[float] = None,
        share_beta: bool = False,
        final_adjust_rots: bool = True,
        scale_target: bool = False,
        scale_fit: bool = False,
        initial_pose_rotvecs=None,
        initial_shape_betas=None,
        initial_kid_factor=None,
        requested_keys=('pose_rotvecs',),
        *,
        batch_mask=None,
    ) -> dict:
        """Alternating closed-form fit of (B, V, 3) target vertices and
        optionally (B, J, 3) target joints, warm-started from
        ``initial_*`` when given. Returns shape_betas (B, n_betas), trans
        (B, 3), orientations and relative_orientations (B, J, 3, 3), kid_factor
        (B,) with the kid column, scale_corr (B,) under ``scale_target`` /
        ``scale_fit``, and on request pose_rotvecs (B, 3J), vertices (B, V, 3)
        and joints (B, J, 3). ``vertex_weights`` (B, V) and ``joint_weights``
        (B, J) weight the fit (see the module docstring). ``num_iter`` - 1
        rounds of shape solve and rotation fit precede the final solve, so a
        ``num_iter`` below 1 fits as 1 does, as in the JAX package.

        ``share_beta`` fits one set of betas (and kid factor) to the whole
        batch; ``batch_mask`` (B,), 1 for real instances and 0 for padding,
        leaves the padding out of that shared solve (every shape solve of the
        fit), so a padded batch gives the unpadded batch's shape. Without
        ``share_beta`` it has no effect: instances never couple."""
        requested_keys = tuple(requested_keys)
        with profiling.span('fit'):
            opt = self._optional
            target_vertices = self.body_model.as_f32(target_vertices)
            batch = target_vertices.shape[0]
            omega_vm, jw_lm = self._call_weights(vertex_weights, joint_weights, batch)
            return self._fit_lm(
                target_vertices, opt(target_joints), omega_vm, jw_lm, num_iter,
                beta_regularizer, beta_regularizer2, scale_regularizer, kid_regularizer,
                final_adjust_rots, scale_target, scale_fit, opt(initial_pose_rotvecs),
                opt(initial_shape_betas), opt(initial_kid_factor), requested_keys, share_beta,
                self._batch_mask(batch_mask, batch))

    def _fit_lm(self, target_vertices, target_joints, omega_vm, jw_lm, num_iter,
                beta_regularizer, beta_regularizer2, scale_regularizer, kid_regularizer,
                final_adjust_rots, scale_target, scale_fit, initial_pose_rotvecs,
                initial_shape_betas, initial_kid_factor, requested_keys, share_beta,
                batch_mask) -> dict:
        bm = self.body_model
        plan = self.plan
        with profiling.span('fit.prepare'):
            scale_any = scale_target or scale_fit
            target_vertices, target_joints, target_mean = _center_targets(
                target_vertices, target_joints, full_mean=scale_any)
            tgt_vm = lbs_kernels.to_vertex_major(target_vertices)
            tj_lm = None if target_joints is None else target_joints.permute(2, 1, 0)
            has_joints = tj_lm is not None
            batch = tgt_vm.shape[2]
            # Per-call ω: the solve is weighted per the both-or-neither rule (the
            # fitter then has no static weights, so `gram` is unweighted).
            gram, jw_solve = self._lm_solve_weights(has_joints)
            wgram_solve = self._solve_weighted(has_joints, omega_vm, jw_lm)
            wk = dict(jw_lm=jw_lm, omega=omega_vm)

        with profiling.span('fit.rotations'):
            if initial_pose_rotvecs is None and initial_shape_betas is None:
                rj0 = bm.J_template.T[:, :, None] if has_joints else None
                glob9 = fit_global_rotations_lm(bm, plan, tgt_vm, tj_lm, plan.default_mesh_vm, rj0,
                                                **wk)
            else:
                # Warm start: the first rotation fit runs against the initial
                # parameters' reconstruction and composes onto their rotations.
                glob9_0 = self._glob9_from_pose(initial_pose_rotvecs, batch)
                x0 = self._shape_cols(initial_shape_betas, initial_kid_factor, batch)
                spec0, rj0, _ = lbs_recon_spec_lm(bm, plan, self.gram, glob9_0, x0.T.contiguous())
                glob9 = rot_ops.matmul3x3_lm(
                    fit_rotations_to_spec_lm(bm, plan, tgt_vm, tj_lm, spec0, rj0, **wk), glob9_0)

        # With target joints the fitted mesh reaches the rotation fits as
        # kernel operands; without, it is made (K1) to regress joints from.
        recon_key = 'recon_spec' if has_joints else 'vertices_vm'

        def solve(g9, keys, scale=False):
            kw = dict(kid_regularizer=kid_regularizer,
                      beta_regularizer_reference=initial_shape_betas,
                      kid_regularizer_reference=initial_kid_factor, requested_keys=keys,
                      scale_target=scale and scale_target, scale_fit=scale and scale_fit,
                      scale_regularizer=scale_regularizer, share_beta=share_beta,
                      batch_mask=batch_mask)
            if wgram_solve:
                return fit_shape_wgram_lm(bm, plan, gram, g9, tgt_vm, tj_lm, omega_vm,
                                          jw_lm if has_joints else None, beta_regularizer,
                                          beta_regularizer2, **kw)
            return fit_shape_gram_lm(bm, plan, gram, g9, tgt_vm, tj_lm, beta_regularizer,
                                     beta_regularizer2, jw_static=jw_solve, **kw)

        for _ in range(num_iter - 1):
            with profiling.span('fit.solve'):
                res = solve(glob9, (recon_key, 'joints_lm') if has_joints else (recon_key,))
            with profiling.span('fit.rotations'):
                glob9 = rot_ops.matmul3x3_lm(
                    fit_global_rotations_lm(bm, plan, tgt_vm, tj_lm, res.get('vertices_vm'),
                                            res.get('joints_lm'),
                                            reference_spec=res.get('recon_spec'), **wk),
                    glob9)
        with profiling.span('fit.solve'):
            res = solve(glob9, (recon_key, 'joints_lm') if (has_joints or final_adjust_rots)
                        else (recon_key,), scale=scale_any)

        if final_adjust_rots:
            with profiling.span('fit.adjust'):
                # scale_target scales the targets by the fitted factor; scale_fit
                # scales the reconstruction about its translation,
                # pos' = s pos + (1 - s) t, applied to the spec by scaling its
                # [R|t] entries (exact: LBS is linear in them and skinning rows
                # sum to 1), and the tree walk by the scaled model joints.
                adj_tgt_vm, adj_tj = tgt_vm, tj_lm
                ref_vm, ref_spec = res.get('vertices_vm'), res.get('recon_spec')
                ref_j = res['joints_lm']
                adj_scale_corr = None
                factor = res['scale_corr']
                if scale_target:
                    adj_tgt_vm = tgt_vm * factor
                    adj_tj = None if tj_lm is None else tj_lm * factor
                elif scale_fit:
                    shift = (1.0 - factor)[None, :] * res['trans_lm']  # (3, B)
                    if ref_vm is not None:
                        ref_vm = ref_vm * factor + shift[:, None, :]
                    ref_j = ref_j * factor + shift[:, None, :]
                    if ref_spec is not None:
                        pj = ref_spec['pj_cm'] * factor
                        pj[3::4] += shift[:, None, :]
                        ref_spec = dict(ref_spec, pj_cm=pj)
                    adj_scale_corr = factor
                glob9 = fit_global_rotations_dependent_lm(
                    bm, plan, adj_tgt_vm, adj_tj, ref_vm, ref_j, glob9, res['shape_betas'],
                    res['trans_lm'], res['kid_factor'], reference_spec=ref_spec,
                    scale_corr=adj_scale_corr, **wk)

        with profiling.span('fit.outputs'):
            if scale_target:
                trans_out = res['trans'] + target_mean * res['scale_corr'][:, None]
            elif scale_fit:
                trans_out = res['trans'] + target_mean / res['scale_corr'][:, None]
            else:
                trans_out = res['trans'] + target_mean
            J = bm.num_joints
            orientations = glob9.permute(2, 1, 0).reshape(batch, J, 3, 3)
            result = dict(
                shape_betas=res['shape_betas'],
                kid_factor=res['kid_factor'],
                scale_corr=res['scale_corr'],
                trans=trans_out,
                relative_orientations=res['relative_orientations_lm'].permute(2, 1, 0).reshape(
                    batch, J, 3, 3),
                orientations=orientations,
            )
            if 'joints' in requested_keys or 'vertices' in requested_keys:
                forw = bm(glob_rotmats=orientations, shape_betas=res['shape_betas'],
                          trans=res['trans'] + target_mean, kid_factor=res['kid_factor'],
                          return_vertices='vertices' in requested_keys)
                for key in ('joints', 'vertices'):
                    if key in requested_keys:
                        result[key] = forw[key]
            _lm_rotation_formats(bm, result, glob9, requested_keys)
            return {k: v for k, v in result.items() if v is not None}

    def fit_with_known_pose(
        self,
        pose_rotvecs,
        target_vertices,
        target_joints=None,
        vertex_weights=None,
        joint_weights=None,
        beta_regularizer: float = 1.0,
        beta_regularizer2: float = 0.0,
        scale_regularizer: float = 0.0,
        kid_regularizer: Optional[float] = None,
        share_beta: bool = False,
        scale_target: bool = False,
        scale_fit: bool = False,
        beta_regularizer_reference=None,
        kid_regularizer_reference=None,
        requested_keys=('shape_betas',),
        *,
        batch_mask=None,
    ) -> dict:
        """Shape, translation (and optionally kid factor and scale) for known
        pose rotation vectors (B, 3J): one shape solve. Returns shape_betas,
        trans, orientations and relative_orientations (B, J, 3, 3), and
        kid_factor / scale_corr where they are fitted; the target mean is
        restored unscaled. Weights as in :meth:`fit`; only the shape solve
        sees them. ``share_beta`` and ``batch_mask`` as in :meth:`fit`."""
        bm = self.body_model
        target_vertices = bm.as_f32(target_vertices)
        batch = target_vertices.shape[0]
        omega_vm, jw_lm = self._call_weights(vertex_weights, joint_weights, batch)
        batch_mask = self._batch_mask(batch_mask, batch)
        target_vertices, target_joints, target_mean = _center_targets(
            target_vertices, self._optional(target_joints), full_mean=scale_target or scale_fit)
        glob9 = self._glob9_from_pose(pose_rotvecs, batch)
        tj_lm = None if target_joints is None else target_joints.permute(2, 1, 0)
        has_joints = tj_lm is not None
        tgt_vm = lbs_kernels.to_vertex_major(target_vertices)
        kw = dict(kid_regularizer=kid_regularizer,
                  beta_regularizer_reference=self._optional(beta_regularizer_reference),
                  kid_regularizer_reference=self._optional(kid_regularizer_reference),
                  scale_target=scale_target, scale_fit=scale_fit,
                  scale_regularizer=scale_regularizer, share_beta=share_beta,
                  batch_mask=batch_mask)
        if self._solve_weighted(has_joints, omega_vm, jw_lm):
            res = fit_shape_wgram_lm(bm, self.plan, self.gram, glob9, tgt_vm, tj_lm, omega_vm,
                                     jw_lm if has_joints else None, beta_regularizer,
                                     beta_regularizer2, **kw)
        else:
            gram, jw_solve = self._lm_solve_weights(has_joints)
            res = fit_shape_gram_lm(bm, self.plan, gram, glob9, tgt_vm, tj_lm, beta_regularizer,
                                    beta_regularizer2, jw_static=jw_solve, **kw)
        result = dict(
            shape_betas=res['shape_betas'],
            kid_factor=res['kid_factor'],
            scale_corr=res['scale_corr'],
            trans=res['trans'] + target_mean,
            orientations=glob9.permute(2, 1, 0).reshape(batch, bm.num_joints, 3, 3),
            relative_orientations=res['relative_orientations_lm'].permute(2, 1, 0).reshape(
                batch, bm.num_joints, 3, 3),
        )
        return {k: v for k, v in result.items() if v is not None}

    def fit_with_known_shape(
        self,
        shape_betas,
        target_vertices,
        target_joints=None,
        vertex_weights=None,
        joint_weights=None,
        kid_factor=None,
        num_iter: int = 1,
        final_adjust_rots: bool = True,
        initial_pose_rotvecs=None,
        scale_fit: bool = False,
        requested_keys=('pose_rotvecs',),
    ) -> dict:
        """Pose and translation (and with ``scale_fit`` a scale) for known
        shape betas (B, <= n_betas) and kid factors (B,): ``num_iter``
        rotation fits against the known shape's reconstruction, from the
        T-pose or ``initial_pose_rotvecs``, then the translation and the
        optional final adjustment. Returns shape_betas, trans, orientations,
        kid_factor when given, scale_corr under ``scale_fit``, and on request
        pose_rotvecs / relative_orientations. Weights as in :meth:`fit`; the
        translation (and scale) is their weighted Procrustes mean under the
        both-or-neither rule.

        A kid factor on a fitter without the kid column has no column in the
        reconstruction operands; the known shape's mesh is then made by the
        body model (K1) for every rotation fit. That case and ``scale_fit``
        follow the JAX package's batch-major formulation: one rotation fit and
        ``num_iter`` - 1 more, so one even at ``num_iter`` 0, then the
        Procrustes translation (and scale) against the mesh."""
        bm = self.body_model
        plan = self.plan
        gram = self.gram
        J = bm.num_joints
        V = bm.num_vertices
        target_vertices = bm.as_f32(target_vertices)
        batch = target_vertices.shape[0]
        omega_vm, jw_lm = self._call_weights(vertex_weights, joint_weights, batch)
        wk = dict(jw_lm=jw_lm, omega=omega_vm)
        target_vertices, target_joints, target_mean = _center_targets(
            target_vertices, self._optional(target_joints))
        tgt_vm = lbs_kernels.to_vertex_major(target_vertices)
        tj_lm = None if target_joints is None else target_joints.permute(2, 1, 0)
        has_joints = tj_lm is not None
        kid_factor = self._optional(kid_factor)
        if kid_factor is not None:
            kid_factor = kid_factor.reshape(batch)
        x = self._shape_cols(self._optional(shape_betas), kid_factor, batch)
        x_T = x.T.contiguous()

        glob9 = self._glob9_from_pose(initial_pose_rotvecs, batch)
        kid_mesh = kid_factor is not None and not self.enable_kid
        if kid_mesh:
            def kid_recon(g9):
                """The known shape's mesh (3, V, B) and joints (3, J, B) under g9."""
                forw = bm(glob_rotmats=g9.permute(2, 1, 0).reshape(batch, J, 3, 3),
                          shape_betas=x[:, :self.n_betas], kid_factor=kid_factor)
                return (lbs_kernels.to_vertex_major(forw['vertices']),
                        forw['joints'].permute(2, 1, 0))

            for _ in range(max(num_iter, 1)):
                ref_vm, rj = kid_recon(glob9)
                glob9 = rot_ops.matmul3x3_lm(
                    fit_global_rotations_lm(bm, plan, tgt_vm, tj_lm, ref_vm,
                                            rj if has_joints else None, **wk), glob9)
        else:
            for _ in range(max(num_iter, 1) if scale_fit else num_iter):
                spec, rj, _ = lbs_recon_spec_lm(bm, plan, gram, glob9, x_T)
                glob9 = rot_ops.matmul3x3_lm(
                    fit_rotations_to_spec_lm(bm, plan, tgt_vm, tj_lm, spec, rj, **wk), glob9)

        # The translation is weighted per the both-or-neither rule: static
        # weights through the weighted first moments, per-call ω through one
        # materialized reconstruction (K1).
        w_static = self._solve_weighted(has_joints, self.static_vw, self.static_jw)
        w_runtime = self._solve_weighted(has_joints, omega_vm,
                                         None if joint_weights is None else jw_lm)
        scale_corr = None
        recon_f = None
        if kid_mesh:
            recon_f, rj_f = kid_recon(glob9)
        else:
            spec_f, rj_f, rec_sum = lbs_recon_spec_lm(
                bm, plan, self.gram_w if w_static else gram, glob9, x_T)
        if scale_fit or kid_mesh:
            # Procrustes scale and translation against the reconstruction itself.
            if recon_f is None:
                recon_f = _spec_points(spec_f)
            vw_b = jw_b = None
            if omega_vm is not None or w_static:
                vw_b = (omega_vm.T if omega_vm is not None
                        else self.plan.omega_pad[:V, 0][None].expand(batch, V))
            if jw_lm is not None:
                jw_b = jw_lm.T
            scale_corr, trans = fit_scale_and_translation(
                target_vertices, lbs_kernels.from_vertex_major(recon_f, V), target_joints,
                rj_f.permute(2, 1, 0), vw_b, jw_b, scale=scale_fit)
            trans_lm = trans.T
            if scale_corr is not None:
                recon_f, rj_f = recon_f * scale_corr, rj_f * scale_corr
            ref_vm = recon_f + trans_lm[:, None, :]
            ref_j = rj_f + trans_lm[:, None, :]
            ref_spec = None
        else:
            # Translation: the (weighted) mean gap of vertices (and joints),
            # with the reconstruction's sum from the first moments.
            if w_runtime:
                recon_f = _spec_points(spec_f)
                rec_sum = torch.einsum('vb,cvb->cb', omega_vm, recon_f[:, :V])
                tgt_sum = torch.einsum('vb,cvb->cb', omega_vm, tgt_vm[:, :V])
                w_tot = omega_vm.sum(dim=0)
            elif w_static:
                tgt_sum = torch.einsum('v,cvb->cb', self.plan.omega_pad[:V, 0], tgt_vm[:, :V])
                w_tot = self.gram_w.w_total
            else:
                tgt_sum = tgt_vm[:, :V].sum(dim=1)
                w_tot = float(V)
            if has_joints:
                if w_runtime or w_static:
                    tgt_sum = tgt_sum + torch.einsum('jb,cjb->cb', jw_lm, tj_lm)
                    rec_sum = rec_sum + torch.einsum('jb,cjb->cb', jw_lm, rj_f)
                    w_tot = w_tot + jw_lm.sum(dim=0)
                else:
                    tgt_sum = tgt_sum + tj_lm.sum(dim=1)
                    rec_sum = rec_sum + rj_f.sum(dim=1)
                    w_tot += J
            trans_lm = (tgt_sum - rec_sum) / w_tot  # (3, B)
            ref_j = rj_f + trans_lm[:, None, :]
            pj = spec_f['pj_cm'].clone()
            pj[3::4] += trans_lm[:, None, :]
            ref_spec, ref_vm = dict(spec_f, pj_cm=pj), None
            if not has_joints:
                ref_vm = (recon_f + trans_lm[:, None, :] if recon_f is not None
                          else _spec_points(ref_spec))
                ref_spec = None

        if final_adjust_rots:
            glob9 = fit_global_rotations_dependent_lm(
                bm, plan, tgt_vm, tj_lm, ref_vm, ref_j, glob9, x[:, :self.n_betas], trans_lm,
                kid_factor, reference_spec=ref_spec, scale_corr=scale_corr, **wk)

        result = dict(
            shape_betas=x[:, :self.n_betas],
            trans=trans_lm.T + target_mean,
            orientations=glob9.permute(2, 1, 0).reshape(batch, J, 3, 3),
        )
        if kid_factor is not None:
            result['kid_factor'] = kid_factor
        if scale_corr is not None:
            result['scale_corr'] = scale_corr
        _lm_rotation_formats(bm, result, glob9, tuple(requested_keys))
        return result

    def fit_scale_and_translation(self, target_vertices, reference_vertices, target_joints=None,
                                  reference_joints=None, vertex_weights=None, joint_weights=None,
                                  scale: bool = False) -> dict:
        """Procrustes scale and translation between fixed point sets (no
        rotation or shape change), aligning the reference onto the target:
        ``{'trans': (B, 3)}`` plus ``'scale_corr'`` (B,) when ``scale``.
        ``vertex_weights`` (B, V) and ``joint_weights`` (B, J) weight the
        means and spreads (with joints only when both are given)."""
        bm = self.body_model
        opt = self._optional
        scale_corr, trans = fit_scale_and_translation(
            bm.as_f32(target_vertices), bm.as_f32(reference_vertices), opt(target_joints),
            opt(reference_joints), opt(vertex_weights), opt(joint_weights), scale=scale)
        result = {'trans': trans}
        if scale_corr is not None:
            result['scale_corr'] = scale_corr
        return result

    def check_kernel_parity(self, batch: int = 32, num_iter: int = 2, seed: int = 0,
                            betas_atol: float = 1e-3, v2v_atol_mm: float = 0.05,
                            raise_on_fail: bool = True) -> dict:
        """Hold this fitter's kernels to their plain twins on its own model.

        Makes one seeded batch on the model (:func:`parity_targets`), fits
        it on the card through the kernels and on a CPU copy of the fitter
        (the same weights, static fit weights and kid column), where the
        wrappers run their plain PyTorch twins, with the same arguments
        (``num_iter``, beta_regularizer=1, final rotation adjustment), and
        holds the two by :func:`parity_gate`: max|d betas| (and kid factor)
        within ``betas_atol`` and the mean reconstruction errors within
        ``v2v_atol_mm``. Call it once on a fitter for a new model file, or
        through ``python -m smplfitter_tpu_torch.precompile --check-parity``.

        Returns ``dict(ok, max_dbetas, v2v_kernel_mm, v2v_xla_mm)``, where
        ``v2v_xla_mm`` is the CPU twins' error (the JAX package's name for its
        kernel-free formulation). Raises ``AssertionError`` naming the model
        and the measured values out of tolerance, unless
        ``raise_on_fail=False``. A fitter on the CPU has no kernels to check:
        it raises ``RuntimeError``.
        """
        bm = self.body_model
        if not _runs_kernels(bm):
            raise RuntimeError(
                f'check_kernel_parity: this fitter is on {bm.device}, where every wrapper '
                'runs its plain twin; there are no kernels to check. Build the model on a '
                "CUDA device (BodyModel(..., device='cuda')).")
        with torch.no_grad():
            tv, tj = parity_targets(self, batch, seed)
            kw = dict(num_iter=num_iter, beta_regularizer=1.0, final_adjust_rots=True,
                      requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
            ours = self.fit(tv, tj, **kw)
            cpu_bm = BodyModel.from_model_data(bm.model_data, bm.model_name, bm.gender,
                                               device='cpu')
            cpu = BodyFitter(cpu_bm, enable_kid=self.enable_kid, num_betas=self.n_betas,
                             vertex_weights=self.static_vw, joint_weights=self.static_jw)
            twins = cpu.fit(tv.cpu(), tj.cpu(), **kw)
            result = parity_gate(bm, ours, twins, tv, betas_atol, v2v_atol_mm)
        if raise_on_fail and not result['ok']:
            raise AssertionError(
                f'kernel parity check failed on {bm.model_name} ({bm.gender}, '
                f'V={bm.num_vertices}, J={bm.num_joints}, {self.n_betas} betas'
                f'{", kid" if self.enable_kid else ""}; B={batch}, num_iter={num_iter}): '
                f'max|d betas|={result["max_dbetas"]:.3e} (atol {betas_atol:g}), v2v kernels '
                f'{result["v2v_kernel_mm"]:.4f} mm vs CPU twins {result["v2v_xla_mm"]:.4f} mm '
                f'(atol {v2v_atol_mm:g} mm)')
        return result
