"""Plain PyTorch reference of the SMPL-family forward pass and of the
alternating closed-form fit, written from the mathematics and independent of
the program under test: it reads the model files itself and works out again
everything the program derives from them (the zero-point-shifted template,
the joint template and its shape directions, the body parts by dominant
skinning weight, the kinematic levels). It uses no kernel, no cache and no
special layout: batch-major tensors, dense Jacobians, ``torch.linalg``.

The dtype is a parameter: the benchmark's check runs it in float64 on the
card, and the control of that check runs it in float32 with TF32 switched
on, the precision step below the configuration's float32.

The fit (per body, targets centred on the target joints' mean):

1. Orientations against the T-pose mesh: each part with three or more
   joints (itself and its children) takes the rotation closest to the
   weighted cross-covariance of its joints about their mean (Kabsch); each
   part with one joint that of its vertices about the part's joint centre;
   each part with two joints a swing that aligns its bone and the twist
   about the bone that best aligns its vertices. Toe parts copy the feet,
   whose vertices they share.
2. ``num_iter - 1`` times: solve betas and translation for the current
   orientations (the model is linear in them), then refit the orientations
   against the solved mesh and compose.
3. A final solve, then the final adjustment: walking the kinematic tree,
   each adjustable part is re-anchored at its joint as posed by the solved
   bones, and rotated by the closest rotation to its vertex and joint
   covariances.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from portbench.synth import FILE_NAMES

# Parts whose final orientation is refined again after the last solve, and
# the toe parts that copy the feet (SMPL-family convention).
ADJUSTABLE = (1, 2, 4, 5, 7, 8, 16, 17, 18, 19)
TOES_TO_FEET = {10: 7, 11: 8}


def _load_raw(model_dir: str, model: str) -> dict:
    path = os.path.join(model_dir, FILE_NAMES[model])
    if path.endswith('.npz'):
        return dict(np.load(path))
    with open(path, 'rb') as f:
        return pickle.load(f, encoding='latin1')


class RefModel:
    """A body model read from its files, as tensors of ``dtype`` on ``device``."""

    def __init__(self, model_dir: str, model: str, num_betas: int, device, dtype):
        raw = _load_raw(model_dir, model)
        f64 = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
        v_template = f64(raw['v_template'])
        shapedirs = f64(raw['shapedirs'])[:, :, :num_betas]
        posedirs = f64(raw['posedirs'])
        j_reg = raw['J_regressor']
        j_reg = f64(j_reg if isinstance(j_reg, np.ndarray) else j_reg.toarray())
        weights = f64(raw['weights'])
        parents = [int(p) for p in np.asarray(raw['kintree_table'])[0]]
        V, J = weights.shape
        # Joints rest on the template as filed; the template is then shifted
        # so that the pose feature is the raw relative rotations (the pose
        # correctives vanish at the identity, as in the model's definition).
        j_template = j_reg @ v_template
        j_shapedirs = np.einsum('jv,vce->jce', j_reg, shapedirs)
        eye_feat = np.tile(np.eye(3).reshape(-1), J - 1)
        t_pose_mesh = v_template.copy()
        v_template = v_template - posedirs @ eye_feat

        self.model, self.V, self.J, self.E = model, V, J, shapedirs.shape[2]
        self.parents = parents
        self.device, self.dtype = torch.device(device), dtype
        t = lambda x: torch.as_tensor(x, dtype=dtype, device=self.device)  # noqa: E731
        self.v_template = t(v_template)
        self.shapedirs = t(shapedirs)
        self.posedirs = t(posedirs.reshape(V * 3, -1))
        self.weights = t(weights)
        self.j_template = t(j_template)
        self.j_shapedirs = t(j_shapedirs)
        self.t_pose_mesh = t(t_pose_mesh)

        depth = [0] * J
        for j in range(1, J):
            depth[j] = depth[parents[j]] + 1
        self.levels = [[j for j in range(J) if depth[j] == d] for d in range(1, max(depth) + 1)]

        # Body parts: each vertex belongs to the joint of its largest
        # skinning weight; toe vertices belong to the feet.
        part = np.argmax(weights, axis=1)
        for toe, foot in TOES_TO_FEET.items():
            part[part == toe] = foot
        self.part_of_vertex = torch.as_tensor(part, device=self.device)
        member = np.zeros((J, V))
        member[part, np.arange(V)] = 1.0
        self.member = t(member)
        self.children_and_self = [[j] for j in range(J)]
        for j in range(1, J):
            self.children_and_self[parents[j]].append(j)
        parts = [j for j in range(J) if j not in TOES_TO_FEET]
        self.multi = [j for j in parts if len(self.children_and_self[j]) >= 3]
        self.bones = [j for j in parts if len(self.children_and_self[j]) == 2]
        self.leaves = [j for j in parts if len(self.children_and_self[j]) == 1]
        multi_member = np.zeros((len(self.multi), J))
        for k, j in enumerate(self.multi):
            multi_member[k, self.children_and_self[j]] = 1.0
        self.multi_member = t(multi_member)
        center = np.zeros((J, J))
        for j in range(J):
            center[j, self.children_and_self[j]] = 1.0 / len(self.children_and_self[j])
        self.center = t(center)
        self.vertices_of = [torch.nonzero(self.part_of_vertex == j)[:, 0] for j in range(J)]

    # -- kinematics ---------------------------------------------------------

    def fk_rotations(self, rel):
        """Global rotations (B, J, 3, 3) from parent-relative ones."""
        glob = [rel[:, 0]]
        for j in range(1, self.J):
            glob.append(glob[self.parents[j]] @ rel[:, j])
        return torch.stack(glob, dim=1)

    def relative(self, glob):
        parent = torch.cat([torch.eye(3, dtype=glob.dtype, device=glob.device).expand(
            glob.shape[0], 1, 3, 3), glob[:, self.parents[1:]]], dim=1)
        return parent.transpose(-1, -2) @ glob

    def fk_positions(self, glob, rest):
        """Posed joint positions of rest joints ``rest`` (B, J, 3, ...) whose
        trailing dims ride along (the shape Jacobian's columns)."""
        pos = [rest[:, 0]]
        for j in range(1, self.J):
            p = self.parents[j]
            bone = rest[:, j] - rest[:, p]
            pos.append(pos[p] + torch.einsum('bcd,bd...->bc...', glob[:, p], bone))
        return torch.stack(pos, dim=1)

    def posed_parts(self, glob):
        """The pose-dependent parts of the mesh for global rotations ``glob``:
        the blended rotations (B, V, 3, 3), the posed template (B, V, 3),
        and the joints' position (B, J, 3) and shape Jacobian (B, J, 3, E)."""
        B = glob.shape[0]
        feat = self.relative(glob)[:, 1:].reshape(B, -1)
        v_posed = self.v_template + (feat @ self.posedirs.T).reshape(B, self.V, 3)
        p = self.fk_positions(glob, self.j_template.expand(B, self.J, 3))
        P = self.fk_positions(glob, self.j_shapedirs.expand(B, self.J, 3, self.E))
        rot_blend = torch.einsum('vj,bjx->bvx', self.weights,
                                 glob.reshape(B, self.J, 9)).reshape(B, self.V, 3, 3)
        return rot_blend, v_posed, p, P

    def mesh_and_jacobian(self, glob):
        """Mesh (B, V, 3) at zero betas and its betas Jacobian (B, V, 3, E),
        with the joints (B, J, 3) and theirs (B, J, 3, E)."""
        rot_blend, v_posed, p, P = self.posed_parts(glob)
        t0 = p - torch.einsum('bjcd,jd->bjc', glob, self.j_template)
        T = P - torch.einsum('bjcd,jde->bjce', glob, self.j_shapedirs)
        mesh = (torch.einsum('bvcd,bvd->bvc', rot_blend, v_posed)
                + torch.einsum('vj,bjc->bvc', self.weights, t0))
        jac = (torch.einsum('bvcd,vde->bvce', rot_blend, self.shapedirs)
               + torch.einsum('vj,bjce->bvce', self.weights, T))
        return mesh, jac, p, P

    def forward(self, pose_rotvecs, betas, trans):
        """Vertices (B, V, 3) and joints (B, J, 3)."""
        B = pose_rotvecs.shape[0]
        glob = self.fk_rotations(rodrigues(pose_rotvecs.reshape(B, self.J, 3)))
        rot_blend, v_posed, p, P = self.posed_parts(glob)
        rest = self.j_template + torch.einsum('jce,be->bjc', self.j_shapedirs, betas)
        joints = self.fk_positions(glob, rest)
        t = joints - torch.einsum('bjcd,bjd->bjc', glob, rest)
        shaped = v_posed + torch.einsum('vce,be->bvc', self.shapedirs, betas)
        verts = (torch.einsum('bvcd,bvd->bvc', rot_blend, shaped)
                 + torch.einsum('vj,bjc->bvc', self.weights, t))
        return verts + trans[:, None], joints + trans[:, None]

    # -- the fit --------------------------------------------------------------

    def fit(self, target_vertices, target_joints, vertex_weights=None, joint_weights=None,
            num_iter=3, beta_regularizer=1.0, beta_regularizer2=0.0, final_adjust_rots=True):
        """The closed-form fit; returns pose_rotvecs (B, 3J), shape_betas
        (B, E) and trans (B, 3). Vertex and joint weights weight the part
        covariances and the joint Kabsch; the shape solve is weighted when
        both are given."""
        mean = target_joints.mean(dim=1, keepdim=True)
        tv, tj = target_vertices - mean, target_joints - mean
        B = tv.shape[0]
        om = (torch.ones((B, self.V), dtype=tv.dtype, device=tv.device)
              if vertex_weights is None else vertex_weights)
        jw = (torch.ones((B, self.J), dtype=tv.dtype, device=tv.device)
              if joint_weights is None else joint_weights)
        solve_w = None
        if vertex_weights is not None and joint_weights is not None:
            solve_w = torch.cat([vertex_weights, joint_weights], dim=1)
        l2 = torch.full((self.E,), beta_regularizer, dtype=tv.dtype, device=tv.device)
        l2[:2] = beta_regularizer2

        glob = self.fit_rotations(tv, tj, self.t_pose_mesh.expand(B, self.V, 3),
                                  self.j_template.expand(B, self.J, 3), om, jw)
        for _ in range(num_iter - 1):
            betas, trans, mesh, joints = self.solve_shape(glob, tv, tj, solve_w, l2)
            glob = self.fit_rotations(tv, tj, mesh, joints, om, jw) @ glob
        betas, trans, mesh, joints = self.solve_shape(glob, tv, tj, solve_w, l2)
        if final_adjust_rots:
            glob = self.adjust_rotations(tv, tj, mesh, joints, glob, betas, trans, om, jw)
        rotvecs = log_rotation(self.relative(glob)).reshape(B, -1)
        return dict(pose_rotvecs=rotvecs, shape_betas=betas, trans=trans + mean[:, 0])

    def part_covariances(self, t, a, om, ct, ca, verts=None):
        """sum over each part's vertices of om (t - ct) (a - ca)^T, (B, J, 3, 3);
        ``ct``/``ca`` (B, J, 3) are the parts' centres; ``verts`` limits the
        sum to those vertices."""
        part = self.part_of_vertex if verts is None else self.part_of_vertex[verts]
        member = self.member if verts is None else self.member[:, verts]
        if verts is not None:
            t, a, om = t[:, verts], a[:, verts], om[:, verts]
        tc = t - ct[:, part]
        ac = a - ca[:, part]
        outer = (om[..., None, None] * tc[..., :, None] * ac[..., None, :]).reshape(
            t.shape[0], -1, 9)
        return torch.einsum('jv,bvx->bjx', member, outer).reshape(-1, self.J, 3, 3)

    def fit_rotations(self, tv, tj, av, aj, om, jw):
        """Each part's global rotation taking the reference (``av``, ``aj``)
        onto the targets, (B, J, 3, 3)."""
        ct = torch.einsum('jk,bkc->bjc', self.center, tj)
        ca = torch.einsum('jk,bkc->bjc', self.center, aj)
        A = self.part_covariances(tv, av, om, ct, ca)
        R = [None] * self.J
        # Parts of three or more joints: Kabsch on the joints about their mean.
        m = self.multi
        dt = tj[:, None] - ct[:, m, None]
        da = aj[:, None] - ca[:, m, None]
        wm = self.multi_member[None] * jw[:, None]  # (B, n_multi, J)
        A_multi = torch.einsum('bmk,bmkc,bmkd->bmcd', wm, dt, da)
        for k, R_k in zip(m + self.leaves,
                          closest_rotation(torch.cat([A_multi, A[:, self.leaves]], dim=1))
                          .unbind(1)):
            R[k] = R_k
        # Two-joint parts: swing the bone onto the target's, then twist.
        i0 = self.bones
        i1 = [self.children_and_self[j][1] for j in i0]
        b_ref = _unit(aj[:, i1] - aj[:, i0])
        b_tgt = _unit(tj[:, i1] - tj[:, i0])
        swing = rotation_between(b_ref, b_tgt)
        H = swing @ A[:, i0].transpose(-1, -2)
        vee = torch.stack([H[..., 1, 2] - H[..., 2, 1], H[..., 2, 0] - H[..., 0, 2],
                           H[..., 0, 1] - H[..., 1, 0]], dim=-1)
        tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
        bHb = torch.einsum('bpi,bpij,bpj->bp', b_tgt, H, b_tgt)
        angle = torch.atan2((b_tgt * vee).sum(-1), tr - bHb)
        R_bone = rodrigues(b_tgt * angle[..., None]) @ swing
        for k, R_k in zip(i0, R_bone.unbind(1)):
            R[k] = R_k
        for toe, foot in TOES_TO_FEET.items():
            R[toe] = R[foot]
        return torch.stack(R, dim=1)

    def solve_shape(self, glob, tv, tj, w, l2):
        """Betas and translation minimising the (weighted) squared distances
        of the posed mesh and joints to the targets plus sum l2 betas^2, for
        fixed global rotations. Returns betas, trans, mesh and joints."""
        mesh0, jac_v, p, P = self.mesh_and_jacobian(glob)
        B = tv.shape[0]
        A = torch.cat([jac_v, P], dim=1)  # (B, N, 3, E)
        b = torch.cat([tv - mesh0, tj - p], dim=1)  # (B, N, 3)
        if w is None:
            w = torch.ones(A.shape[:2], dtype=A.dtype, device=A.device)
        w_sum = w.sum(dim=1)
        mean_A = torch.einsum('bn,bnce->bce', w, A) / w_sum[:, None, None]
        mean_b = torch.einsum('bn,bnc->bc', w, b) / w_sum[:, None]
        Ac = (A - mean_A[:, None]).reshape(B, -1, self.E)
        bc = (b - mean_b[:, None]).reshape(B, -1)
        w3 = w.repeat_interleave(3, dim=1)
        G = torch.einsum('bn,bne,bnf->bef', w3, Ac, Ac) + torch.diag(l2)
        r = torch.einsum('bn,bne,bn->be', w3, Ac, bc)
        betas = torch.linalg.solve(G, r)
        trans = mean_b - torch.einsum('bce,be->bc', mean_A, betas)
        mesh = mesh0 + torch.einsum('bvce,be->bvc', jac_v, betas) + trans[:, None]
        joints = p + torch.einsum('bjce,be->bjc', P, betas) + trans[:, None]
        return betas, trans, mesh, joints

    def adjust_rotations(self, tv, tj, mesh, joints, glob, betas, trans, om, jw):
        """The final adjustment: walk the tree from the solved bones, and
        refine each adjustable part about its re-posed joint."""
        B = tv.shape[0]
        rest = self.j_template + torch.einsum('jce,be->bjc', self.j_shapedirs, betas)
        parent_rest = torch.cat([torch.zeros_like(rest[:, :1]), rest[:, self.parents[1:]]], 1)
        bones = rest - parent_rest
        R = list(glob.unbind(1))
        pos = [None] * self.J
        pos[0] = rest[:, 0] + trans
        adjustable = [j for j in ADJUSTABLE if j < self.J]
        last = max(d for d, level in enumerate(self.levels) if set(level) & set(adjustable))

        def refine(parts):
            verts = torch.cat([self.vertices_of[j] for j in parts])
            ct = torch.zeros((B, self.J, 3), dtype=tv.dtype, device=tv.device)
            ct[:, parts] = torch.stack([pos[j] for j in parts], dim=1)
            ca = joints
            A = self.part_covariances(tv, mesh, om, ct, ca, verts)[:, parts]
            for k, j in enumerate(parts):
                ks = self.children_and_self[j]
                dt = tj[:, ks] - pos[j][:, None]
                da = (joints[:, ks] - joints[:, j:j + 1]) * jw[:, ks, None]
                A[:, k] = A[:, k] + torch.einsum('bkc,bkd->bcd', dt, da)
            for j, R_j in zip(parts, closest_rotation(A).unbind(1)):
                R[j] = R_j @ glob[:, j]

        if 0 in adjustable:
            refine([0])
        for d, level in enumerate(self.levels):
            if d > last:
                break
            for j in level:
                p = self.parents[j]
                pos[j] = pos[p] + torch.einsum('bcd,bd->bc', R[p], bones[:, j])
            parts = [j for j in level if j in adjustable]
            if parts:
                refine(parts)
        for toe, foot in TOES_TO_FEET.items():
            R[toe] = R[foot]
        return torch.stack(R, dim=1)


# -- rotations -------------------------------------------------------------


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], dim=-1).reshape(*v.shape[:-1], 3, 3)


def rodrigues(rotvec):
    """Rotation matrices (..., 3, 3) of rotation vectors (..., 3)."""
    angle = torch.linalg.vector_norm(rotvec, dim=-1)[..., None, None]
    K = skew(rotvec)
    small = angle < 1e-8
    safe = torch.where(small, torch.ones_like(angle), angle)
    a = torch.where(small, torch.ones_like(angle), torch.sin(safe) / safe)
    b = torch.where(small, 0.5 * torch.ones_like(angle), (1 - torch.cos(safe)) / safe ** 2)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    return eye + a * K + b * (K @ K)


def rotation_between(a, b):
    """The rotation of least angle taking unit vectors a onto b (..., 3)."""
    axis = torch.linalg.cross(a, b)
    angle = torch.atan2(torch.linalg.vector_norm(axis, dim=-1), (a * b).sum(-1))
    return rodrigues(_unit(axis) * angle[..., None])


def closest_rotation(A):
    """The rotation nearest each (..., 3, 3) matrix in the Frobenius norm."""
    U, _, Vh = torch.linalg.svd(A)
    d = torch.linalg.det(U @ Vh)
    fix = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    fix[..., 2] = d
    return (U * fix[..., None, :]) @ Vh


def log_rotation(R):
    """Rotation vectors (..., 3) of rotation matrices (angles below pi)."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1) / 2
    s = torch.linalg.vector_norm(vee, dim=-1, keepdim=True)
    c = (R.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True) - 1) / 2
    angle = torch.atan2(s, c)
    scale = torch.where(s > 1e-12, angle / torch.clamp(s, min=1e-30), torch.ones_like(s))
    return vee * scale
