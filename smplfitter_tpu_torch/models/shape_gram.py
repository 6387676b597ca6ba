"""Moment-tensor shape solve, ported from ``smplfitter_tpu.models.shape_gram``.

The beta-Jacobian of every vertex has low-rank structure in the joints,

    jac_v = Rbar_v . SD_v + Tbar_v,   Rbar_v = sum_j w_vj R_j,   Tbar_v = sum_j w_vj T_j,

so every vertex sum of the normal equations factors through joint-pair
moments of the static skinning weights and shape directions (``Ksd``,
``Lz_e``, ``q``, ...), precomputed once per model in f64 on the host. Per
call, one kernel (K2) reduces the residual over the vertices and another (K3,
or at large J the streamed term1 kernel K8) assembles each instance's Gramian
from joint-space operands; the translation is eliminated jointly in a small
augmented SPD system. Models with a wide pose template (SMPL-X, SMPL+H) first
compute the posed template as a kernel of its own (K7) and run K2's cached
form on it.

Fit weights take two routes. Static weights ω (V,) of a weighted fitter are
baked into the moments (``build_gram_data(vertex_weights=)``): K2 weights
the residual by the column ``omega_pad`` and K3 / K8 read the weighted
moments unchanged; static joint weights weight the joints block in tensor
ops. Per-call weights (V, B) break the static moments, so
:func:`fit_shape_wgram_lm` rebuilds the normal equations per vertex (K9),
centred by the exact ω-weighted Jacobian mean.

Ported here: the solve with or without target joints, with the kid column,
warm-start regularizer references, the scale column of ``scale_target`` /
``scale_fit`` and both kinds of fit weights, per instance or with the betas
(and kid factor) shared over the batch (``share_beta``, padding instances
left out by ``batch_mask``: :func:`_solve_partial_share`); and the deferred
reconstruction operands of a known shape (:func:`lbs_recon_spec_lm`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import lbs_kernels
from ..ops import rotation as rot_ops
from ..ops.lstsq import batch_reduce_sum, solve_spd_unrolled
from .bodymodel import index_tensor


@dataclass
class GramData:
    """Per-model operands of the shape solve (float32 tensors on one device)."""

    weights_pad: torch.Tensor  # (V_pad, J)
    consts_pose: torch.Tensor  # (4, V_pad, P + 1): [posedirs4 | v_template4]
    consts_full: torch.Tensor  # (4, V_pad, P + 1 + E): [... | sd4]
    sd_cm: torch.Tensor  # (3, V_pad, E) shape directions, component-major
    Ksd: torch.Tensor  # (9J^2, E^2)  sum_v w_vj w_vk SD_v (x) SD_v, rows ((j,c),(k,d))
    Lz_e: torch.Tensor  # (3J, E*J)  sum_v w_vj w_vk SD_v with rows (j,c), cols (e,k)
    sd1_2d: torch.Tensor  # (3J, E)  sum_v w_vj SD_v, rows (j,c)
    q: torch.Tensor  # (J, J)  sum_v w_vj w_vk
    W1_col: torch.Tensor  # (J, 1)  sum_v w_vj
    # First moments of the full template features (columns of consts_full:
    # [posedirs | v_template | SD]): sum_v rec_v follows from them without the mesh.
    Kc: torch.Tensor  # (J, 3, P + 1 + E)  sum_v w_vj consts_v
    Msd: torch.Tensor  # (V, J*3*E)  w_vj SD_v[c, e], columns (j, c, e): the per-call ω mean
    n_ext: int  # E = number of betas (+1 with the kid column)
    # The cover of the vertices that K1, K2 and K9 walk (lbs_kernels.wgram_cover):
    # segments of at most 32 vertices of one body part, each with its active
    # joints. One object per model, so the checks it records are made once.
    wgram_cover: Optional[lbs_kernels.BlendSegments] = None
    # Static fit weights ω (None: unweighted). With them every moment above
    # except Msd is an ω-weighted vertex sum, and K2 weights the residual by
    # this column; the per-vertex operands stay unweighted (and are shared
    # with the fitter's unweighted GramData).
    omega_pad: Optional[torch.Tensor] = None  # (V_pad, 1), zero rows in the padding
    w_total: float = 0.0  # sum_v ω_v (V without weights)


# The per-vertex operands, the same in the weighted and the unweighted GramData.
SHARED_FIELDS = ('weights_pad', 'consts_pose', 'consts_full', 'sd_cm', 'Msd')


def build_gram_data(weights: np.ndarray, shapedirs: np.ndarray,
                    kid_shapedir: Optional[np.ndarray], n_betas: int,
                    v_template: np.ndarray, posedirs: np.ndarray, device='cpu',
                    vertex_weights: Optional[np.ndarray] = None,
                    shared: Optional[GramData] = None) -> GramData:
    """Host-side (f64) moment precompute; ``weights`` (V, J), ``shapedirs``
    (V, 3, S), ``kid_shapedir`` (V, 3) appended as the last shape column when
    given, ``v_template`` (V, 3), ``posedirs`` (V, 3, P). Vertex order is
    canonical; per-vertex operands are zero-row-padded to a multiple of 256.
    ``vertex_weights`` (V,) bakes static fit weights into the moments;
    ``shared`` (a GramData of the same model) lends its per-vertex operands
    (:data:`SHARED_FIELDS`) instead of building them again."""
    w = np.asarray(weights, np.float64)
    SD = np.asarray(shapedirs, np.float64)[:, :, :n_betas]
    if kid_shapedir is not None:
        SD = np.concatenate([SD, np.asarray(kid_shapedir, np.float64)[:, :, None]], axis=2)
    V, J = w.shape
    E = SD.shape[2]
    omega = None if vertex_weights is None else np.asarray(vertex_weights, np.float64).reshape(V)
    # ω enters every moment exactly once: it weights the vertex sum.
    w_omega = w if omega is None else w * omega[:, None]

    v_pad = -(-V // lbs_kernels.VC) * lbs_kernels.VC

    def pad_rows(x):
        return np.concatenate([x, np.zeros((v_pad - V,) + x.shape[1:])], axis=0)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    # Msd[v, (j,c,e)] = w_vj SD_v[c,e]; Ksd regrouped to rows ((j,c),(k,d)) to
    # match X = sum_a R_a R_a^T with R rows (j,c).
    Msd = (w[:, :, None, None] * SD[:, None, :, :]).reshape(V, J * 3 * E)
    Msd_w = Msd if omega is None else Msd * omega[:, None]
    K = (Msd.T @ Msd_w).reshape(J, 3, E, J, 3, E)
    Ksd = K.transpose(0, 1, 3, 4, 2, 5).reshape(J * 3 * J * 3, E * E)
    Lsd = (Msd.T @ w_omega).reshape(J, 3, E, J).transpose(0, 3, 1, 2)  # (j, k, c, e)
    sd1 = np.einsum('vj,vce->jce', w_omega, SD)
    consts3 = np.concatenate([np.asarray(posedirs, np.float64),
                              np.asarray(v_template, np.float64)[:, :, None], SD], axis=2)

    if shared is not None:
        per_vertex = {name: getattr(shared, name) for name in SHARED_FIELDS}
    else:
        v_template4 = np.concatenate([np.asarray(v_template), np.ones((V, 1))], axis=1)
        posedirs4 = np.concatenate(
            [np.asarray(posedirs), np.zeros((V, 1, posedirs.shape[2]))], axis=1)
        sd4 = np.concatenate([SD, np.zeros((V, 1, E))], axis=1)
        per_vertex = dict(
            weights_pad=f32(pad_rows(w)),
            consts_pose=f32(pad_rows(
                np.concatenate([posedirs4, v_template4[:, :, None]], axis=2)).transpose(1, 0, 2)),
            consts_full=f32(pad_rows(
                np.concatenate([posedirs4, v_template4[:, :, None], sd4], axis=2)
            ).transpose(1, 0, 2)),
            sd_cm=f32(pad_rows(SD).transpose(1, 0, 2)),
            Msd=f32(Msd),
        )

    return GramData(
        **per_vertex,
        wgram_cover=lbs_kernels.wgram_cover(w, V, device),
        Ksd=f32(Ksd),
        Lz_e=f32(np.transpose(Lsd, (0, 2, 3, 1)).reshape(J * 3, E * J)),
        sd1_2d=f32(sd1.reshape(J * 3, E)),
        q=f32(w.T @ w_omega),
        W1_col=f32(w_omega.sum(axis=0).reshape(J, 1)),
        Kc=f32((w_omega.T @ consts3.reshape(V, -1)).reshape(J, 3, consts3.shape[2])),
        n_ext=E,
        omega_pad=None if omega is None else f32(pad_rows(omega.reshape(V, 1))),
        w_total=float(V) if omega is None else float(omega.sum()),
    )


def _fk_ext_prelude(bm, plan, glob_lm) -> dict:
    """Lane-major FK-extended quantities of a shape solve for global rotations
    glob_lm (9, J, B). Keys: rel9 (9, J, B), rot_params_cols ((J-1)*9, B),
    p_j (3, J, B), P4 (3, E, J, B), t_lm (3, J, B), T4 (3, E, J, B),
    pj_cm (12, J, B), feat_cols (F, B)."""
    from .bodyfitter import fk_positions_ext_lm  # bodyfitter imports this module

    batch = glob_lm.shape[2]
    J = bm.num_joints
    dev = glob_lm.device

    eye_col = torch.eye(3, device=dev).reshape(9, 1, 1).expand(9, 1, batch)
    parent9 = torch.cat([eye_col, glob_lm[:, index_tensor(bm.kintree_parents[1:], dev)]], dim=1)
    rel9 = rot_ops.matmul3x3_lm(parent9, glob_lm, transpose_a=True)
    # Pose feature rows (j-major, entry-minor), matching rel.reshape(B, (J-1)*9).
    rot_params_cols = rel9[:, 1:].permute(1, 0, 2).reshape((J - 1) * 9, batch)

    pos4 = fk_positions_ext_lm(bm, plan, glob_lm)  # (3, 1+E, J, B)
    p_j = pos4[:, 0]
    P4 = pos4[:, 1:]
    jte_lm = plan.J_template_ext[..., 0].T[:, :, None]  # (3, J, 1)
    t_lm = torch.stack([
        p_j[a] - sum(glob_lm[a * 3 + c] * jte_lm[c] for c in range(3)) for a in range(3)
    ])
    JTE_lm = plan.J_template_ext[..., 1:].permute(1, 2, 0)[..., None]  # (3, E, J, 1)
    T4 = torch.stack([
        P4[a] - sum(glob_lm[a * 3 + c][None] * JTE_lm[c] for c in range(3)) for a in range(3)
    ])
    pj_cm = torch.stack(
        [glob_lm[a * 3 + c] if c < 3 else t_lm[a] for a in range(3) for c in range(4)])
    feat_cols = torch.cat([rot_params_cols, torch.ones((1, batch), device=dev)], dim=0)
    return dict(glob_lm=glob_lm, rel9=rel9, p_j=p_j, P4=P4, t_lm=t_lm, T4=T4,
                pj_cm=pj_cm, feat_cols=feat_cols)


def fit_shape_gram_lm(bm, plan, gram: GramData, glob_lm, tgt_vm, tj_lm,
                      beta_regularizer: float, beta_regularizer2: float,
                      kid_regularizer: Optional[float] = None,
                      beta_regularizer_reference=None, kid_regularizer_reference=None,
                      requested_keys=(), scale_target: bool = False, scale_fit: bool = False,
                      scale_regularizer: float = 0.0, jw_static=None, share_beta: bool = False,
                      batch_mask=None) -> dict:
    """Lane-major shape solve: rotations glob_lm (9, J, B), targets tgt_vm
    (3, V, B) and tj_lm (3, J, B) or None. A statically weighted ``gram``
    weights the vertex block; ``jw_static`` (J,) weights the joints block,
    which is then assembled in tensor ops outside K3. Returns shape_betas (B, n_betas),
    kid_factor (B,) or None, scale_corr (B,) or None, trans (B, 3), trans_lm
    (3, B), relative_orientations_lm (9, J, B), and on request joints_lm
    (3, J, B), vertices_vm (3, V_pad, B) and recon_spec (the fitted mesh's
    operands for the per-part sums: pj_cm, feat_cols, consts_pad,
    weights_pad, and the posed-template cache homog_vm, x_cols, sd_cm, where
    homog_vm is None unless the solve computed it: always for large-F
    models, else only when recon_spec is requested without a scale column).

    ``scale_target`` / ``scale_fit`` add the scale column from K2's
    target-side moments (the model side follows by linearity, pos = tgt - b).
    ``share_beta`` solves one shape for the whole batch, the instances with
    ``batch_mask`` (B,) 0 left out of it (see :func:`_solve_partial_share`)."""
    batch = glob_lm.shape[2]
    J = bm.num_joints
    E = gram.n_ext
    dev = glob_lm.device
    scale_col = scale_target or scale_fit
    has_joints = tj_lm is not None
    # Static joint weights take the joints block out of K3 (which knows only
    # the unweighted form) into the tensor ops below.
    weighted_joints = has_joints and jw_static is not None
    kernel_joints = has_joints and not weighted_joints
    k2 = dict(cover=gram.wgram_cover)  # K2's keywords: its cover and static fit weights
    if gram.omega_pad is not None:
        k2['omega'] = gram.omega_pad

    pre = _fk_ext_prelude(bm, plan, glob_lm)
    p_j, P4, T4 = pre['p_j'], pre['P4'], pre['T4']
    rhs_args = (tgt_vm, pre['pj_cm'], pre['feat_cols'], gram.weights_pad, gram.consts_pose,
                gram.sd_cm)
    homog_vm = None
    if gram.consts_pose.shape[2] > lbs_kernels.HOMOG_GEMM_MIN_F:
        # Large-F models (SMPL-X, SMPL+H): the posed template once per solve
        # (K7), read by K2's cached form here and by K4 through recon_spec.
        homog_vm = lbs_kernels.posed_template_lm(pre['feat_cols'], gram.consts_pose)
        cached_args = (tgt_vm, pre['pj_cm'], homog_vm, gram.weights_pad, gram.sd_cm)
        if scale_col:
            rk, yk, rtk, ytk, sck = lbs_kernels.rhs_moments_cached(*cached_args, scale=True,
                                                                   **k2)
        else:
            rk, yk = lbs_kernels.rhs_moments_cached(*cached_args, **k2)
    elif scale_col:
        rk, yk, rtk, ytk, sck = lbs_kernels.rhs_moments(*rhs_args, scale=True, **k2)
    elif 'recon_spec' in requested_keys:
        rk, yk, homog_vm = lbs_kernels.rhs_moments_h(*rhs_args, **k2)
    else:
        rk, yk = lbs_kernels.rhs_moments(*rhs_args, **k2)

    R_cm = torch.stack([
        torch.stack([glob_lm[a * 3 + c] for c in range(3)], dim=1).reshape(J * 3, batch)
        for a in range(3)
    ])  # (3, 3J, B), rows (j, c)
    if kernel_joints:
        P_cm = P4.reshape(3, E * J, batch).contiguous()
        bJ_cm = (tj_lm - p_j).contiguous()
    else:
        P_cm = bJ_cm = torch.zeros((3, 1, batch), device=dev)
    Gk, SAk, rbk, Sbk = lbs_kernels.gram_assembly(
        R_cm, T4.reshape(3, E * J, batch), yk, P_cm, bJ_cm, gram.Ksd, gram.Lz_e, gram.sd1_2d,
        gram.q, gram.W1_col, has_joints=kernel_joints)
    G = Gk.T.reshape(batch, E, E)
    SA = SAk.T.reshape(batch, 3, E)
    r = rk.T + rbk.T
    Sb = Sbk.T
    W = torch.full((batch,), gram.w_total + (J if kernel_joints else 0), device=dev)

    if weighted_joints:
        bJ = tj_lm - p_j  # (3, J, B)
        P4w = P4 * jw_static[None, None, :, None]
        G = G + torch.einsum('aejb,afjb->bef', P4w, P4)
        r = r + torch.einsum('aejb,ajb->be', P4w, bJ)
        SA = SA + torch.einsum('aejb,j->bae', P4, jw_static)
        Sb = Sb + torch.einsum('ajb,j->ba', bJ, jw_static)
        W = W + jw_static.sum()

    if scale_col:
        rt_full = rtk.T + torch.einsum('aejb,ajb->be', T4, ytk)
        r_b_vert = rk.T + torch.einsum('aejb,ajb->be', T4, yk)
        sum_t = ytk.sum(dim=1).T  # (B, 3)
        sum_b = yk.sum(dim=1).T
        s_tt, s_tp, s_pp = sck[0], sck[1], sck[2]
        if scale_target:
            g_cross, col_sq, col_b, SA_col = -rt_full, s_tt, -(s_tt - s_tp), -sum_t
        else:
            g_cross, col_sq, col_b, SA_col = rt_full - r_b_vert, s_pp, s_tp - s_pp, sum_t - sum_b
        if has_joints:
            col_joint = -tj_lm if scale_target else p_j
            colw = col_joint if jw_static is None else col_joint * jw_static[None, :, None]
            g_cross = g_cross + torch.einsum('aejb,ajb->be', P4, colw)
            col_sq = col_sq + torch.einsum('ajb,ajb->b', col_joint, colw)
            col_b = col_b + torch.einsum('ajb,ajb->b', tj_lm - p_j, colw)
            SA_col = SA_col + colw.sum(dim=1).T
        G = torch.cat([torch.cat([G, g_cross[:, :, None]], dim=2),
                       torch.cat([g_cross[:, None, :], col_sq[:, None, None]], dim=2)], dim=1)
        SA = torch.cat([SA, SA_col[:, :, None]], dim=2)
        r = torch.cat([r, col_b[:, None]], dim=1)

    return _solve_tail(plan, gram, pre, G, SA, r, Sb, W, beta_regularizer, beta_regularizer2,
                       kid_regularizer, beta_regularizer_reference, kid_regularizer_reference,
                       requested_keys, homog_vm, scale_target, scale_fit, scale_regularizer,
                       share_beta=share_beta, batch_mask=batch_mask)


def _solve_partial_share(G_aug, r_aug, n_shared: int, batch_mask=None):
    """Block elimination of the augmented systems (B, n, n), (B, n) whose first
    ``n_shared`` unknowns are one set for the whole batch and the rest per
    instance: each instance's Schur complement and moment of the shared block
    are summed over the batch (times ``batch_mask`` (B,) when given, so that
    padding instances add nothing), one (n_shared, n_shared) solve gives the
    shared unknowns and each instance's own follow from them. Returns (B, n)."""
    Gss = G_aug[:, :n_shared, :n_shared]
    Gsi = G_aug[:, :n_shared, n_shared:]
    Gii = G_aug[:, n_shared:, n_shared:]
    rs = r_aug[:, :n_shared]
    ri = r_aug[:, n_shared:]

    Ci = solve_spd_unrolled(Gii, Gsi.transpose(1, 2))  # (B, ni, ns)
    di = solve_spd_unrolled(Gii, ri)  # (B, ni)
    schur = Gss - torch.matmul(Gsi, Ci)
    moment = rs - torch.einsum('bse,be->bs', Gsi, di)
    if batch_mask is not None:
        schur = schur * batch_mask[:, None, None]
        moment = moment * batch_mask[:, None]
    # The batch sums (in f64, completed across ranks under cross_shard).
    S = batch_reduce_sum(schur, axis=0)
    rhs = batch_reduce_sum(moment, axis=0)
    xs = solve_spd_unrolled(S[None], rhs[None])[0]  # (ns,)
    xi = di - torch.einsum('bis,s->bi', Ci, xs)
    return torch.cat([xs.expand(G_aug.shape[0], n_shared), xi], dim=1)


def _solve_tail(plan, gram, pre, G, SA, r, Sb, W, beta_regularizer, beta_regularizer2,
                kid_regularizer, beta_regularizer_reference, kid_regularizer_reference,
                requested_keys, homog_vm, scale_target, scale_fit, scale_regularizer,
                trans_shift_jac=None, share_beta: bool = False, batch_mask=None) -> dict:
    """Regularize and solve the augmented [betas (, kid) (, scale), trans]
    system (B, E1 + 3), E1 = E + 1 with a scale column, and build the
    lane-major result dict. ``trans_shift_jac`` (B, 3, E1) undoes a centring
    of the Jacobian by its mean mu: t = t' - mu x. ``share_beta`` shares the
    E shape columns over the batch (``batch_mask`` as in
    :func:`_solve_partial_share`); a scale column stays per instance with
    the translation."""
    glob_lm, p_j, P4, t_lm, T4 = (pre[k] for k in ('glob_lm', 'p_j', 'P4', 't_lm', 'T4'))
    batch = glob_lm.shape[2]
    E = gram.n_ext
    scale_col = scale_target or scale_fit
    E1 = E + (1 if scale_col else 0)
    n_betas = plan.n_betas
    dev = G.device

    # Regularizers pull towards a reference (zero unless given): sum l2 (x - ref)^2.
    # Built by fills on the device: a host list copied in would block the host
    # until the device has caught up.
    l2 = [(2, beta_regularizer2), (n_betas - 2, beta_regularizer)]
    ref = torch.zeros((batch, n_betas), device=dev)
    if beta_regularizer_reference is not None:
        given = beta_regularizer_reference[:, :n_betas]
        ref[:, :given.shape[1]] = given
    refs = [ref]
    if plan.enable_kid:
        l2.append((1, beta_regularizer if kid_regularizer is None else kid_regularizer))
        refs.append(torch.zeros((batch, 1), device=dev) if kid_regularizer_reference is None
                    else kid_regularizer_reference.reshape(batch, 1))
    if scale_col:
        l2.append((1, scale_regularizer))
        refs.append(torch.zeros((batch, 1), device=dev))
    l2 = torch.cat([torch.full((n,), value, device=dev) for n, value in l2])
    l2_rhs = l2 * torch.cat(refs, dim=1)
    if share_beta:
        # The shared pull follows the reference's identity-row semantics: its
        # rows are weighted by l2 once more than the per-instance moment form.
        l2_rhs = l2 * l2_rhs

    eyeW = W[:, None, None] * torch.eye(3, device=dev)
    G_aug = torch.cat([
        torch.cat([G, SA.transpose(1, 2)], dim=2),
        torch.cat([SA, eyeW], dim=2),
    ], dim=1)
    G_aug = G_aug + torch.diag(torch.cat([l2, torch.zeros(3, device=dev)]))
    r_aug = torch.cat([r + l2_rhs, Sb], dim=1)
    if share_beta:
        sol = _solve_partial_share(G_aug, r_aug, n_shared=E, batch_mask=batch_mask)
    else:
        sol = solve_spd_unrolled(G_aug, r_aug)

    new_shape = sol[:, :n_betas]
    new_kid = sol[:, n_betas] if plan.enable_kid else None
    new_scale = sol[:, E] + 1 if scale_col else None
    new_trans = sol[:, E1:]
    if trans_shift_jac is not None:
        new_trans = new_trans - torch.einsum('bae,be->ba', trans_shift_jac, sol[:, :E1])
    if scale_fit:
        # scale_fit scales the model, so the published shape is divided by the scale.
        new_shape = new_shape / new_scale[:, None]
        if new_kid is not None:
            new_kid = new_kid / new_scale
    result = dict(
        shape_betas=new_shape,
        kid_factor=new_kid,
        scale_corr=new_scale,
        trans=new_trans,
        trans_lm=new_trans.T,
        relative_orientations_lm=pre['rel9'],
    )
    x = new_shape if new_kid is None else torch.cat([new_shape, new_kid[:, None]], dim=1)
    x_T = x.T.contiguous()  # (E, B)
    if 'joints_lm' in requested_keys:
        result['joints_lm'] = (
            p_j + sum(P4[:, e] * x_T[e][None, None] for e in range(E))
            + new_trans.T[:, None, :]
        )
    if 'recon_spec' in requested_keys or 'vertices_vm' in requested_keys:
        t2 = t_lm + sum(T4[:, e] * x_T[e][None, None] for e in range(E)) + new_trans.T[:, None, :]
        pj2_cm = torch.stack(
            [glob_lm[a * 3 + c] if c < 3 else t2[a] for a in range(3) for c in range(4)])
        f2_cols = torch.cat([pre['feat_cols'], x_T], dim=0)
        if 'recon_spec' in requested_keys:
            result['recon_spec'] = dict(
                pj_cm=pj2_cm, feat_cols=f2_cols, weights_pad=gram.weights_pad,
                consts_pad=gram.consts_full, homog_vm=homog_vm, x_cols=x_T, sd_cm=gram.sd_cm,
                cover=gram.wgram_cover,
            )
        if 'vertices_vm' in requested_keys:
            result['vertices_vm'] = lbs_kernels.lbs_points(
                pj2_cm, f2_cols, gram.weights_pad, gram.consts_full, cover=gram.wgram_cover)
    return result


def weighted_jac_mean_lm(bm, gram: GramData, glob_lm, T4, omega_vm):
    """The ω-weighted mean of the per-vertex beta-Jacobian, (3, E, B), and the
    weight sums (B,), exact through one product Msd^T ω:

        sum_v ω jac[a, e] = sum_{j,c} R[a, c, j] (sum_v ω w_vj SD_v[c, e]) + sum_j T4 m_j.

    It centres the per-call weighted normal equations: the Jacobian's
    translation columns share a large common mode over the vertices, and an
    uncentred f32 Gramian loses about 3 digits to the cancellation when the
    translation is eliminated."""
    J = bm.num_joints
    E = gram.n_ext
    B = glob_lm.shape[2]
    V = omega_vm.shape[0]
    Lm = torch.matmul(gram.Msd.T, omega_vm).reshape(J, 3, E, B)
    m_j = torch.matmul(gram.weights_pad[:V].T, omega_vm)  # (J, B)
    w_tot = omega_vm.sum(dim=0)
    mu = torch.stack([
        sum(torch.einsum('jeb,jb->eb', Lm[:, c], glob_lm[a * 3 + c]) for c in range(3))
        + torch.einsum('ejb,jb->eb', T4[a], m_j)
        for a in range(3)
    ])  # (3, E, B)
    return mu / torch.clamp(w_tot, min=1e-12), w_tot


def fit_shape_wgram_lm(bm, plan, gram: GramData, glob_lm, tgt_vm, tj_lm, omega_vm, jw_lm,
                       beta_regularizer: float, beta_regularizer2: float,
                       kid_regularizer: Optional[float] = None,
                       beta_regularizer_reference=None, kid_regularizer_reference=None,
                       requested_keys=(), scale_target: bool = False, scale_fit: bool = False,
                       scale_regularizer: float = 0.0, share_beta: bool = False,
                       batch_mask=None) -> dict:
    """Lane-major shape solve under per-call vertex weights ``omega_vm``
    (V, B) and, with target joints, joint weights ``jw_lm`` (J, B) (None
    without joints; the caller applies the both-or-neither rule). ``gram``
    is the unweighted GramData: ω reaches the solve only through K9, which
    rebuilds the centred normal equations per vertex (the scale column of
    ``scale_target`` / ``scale_fit`` in-kernel). ``share_beta`` and
    ``batch_mask`` as in :func:`fit_shape_gram_lm`: the solve's variables
    are the shape x itself and the centred translation t' = t + mu x, so the
    shared block stays x and t is shifted back per instance after the solve.
    Returns what :func:`fit_shape_gram_lm` returns."""
    batch = glob_lm.shape[2]
    E = gram.n_ext
    scale_mode = 1 if scale_target else (2 if scale_fit else 0)

    pre = _fk_ext_prelude(bm, plan, glob_lm)
    T4 = pre['T4']
    t4_cm = T4.reshape(3 * E, bm.num_joints, batch)  # rows (a, e)
    mu, w_tot = weighted_jac_mean_lm(bm, gram, glob_lm, T4, omega_vm)  # (3, E, B)
    mu_s = None
    mu_full = mu
    if scale_mode:
        # The scale column's centring: minus or plus the ω-weighted target
        # mean. Any per-column constant is exact here (it folds into the
        # translation's change of variables); it only removes the common mode.
        t_mean = (torch.einsum('avb,vb->ab', tgt_vm[:, :omega_vm.shape[0]], omega_vm)
                  / torch.clamp(w_tot, min=1e-12))
        mu_s = (-t_mean if scale_target else t_mean).contiguous()
        mu_full = torch.cat([mu, mu_s[:, None, :]], dim=1)  # (3, E1, B)
    # The posed template once per solve (K7): read by K9 here and by K4
    # through recon_spec.
    homog_vm = lbs_kernels.posed_template_lm(pre['feat_cols'], gram.consts_pose)
    Gk, SAk, rk, Sbk, Wk = lbs_kernels.wgram_moments(
        tgt_vm, pre['pj_cm'], homog_vm, t4_cm, gram.weights_pad, gram.sd_cm,
        mu.reshape(3 * E, batch).contiguous(), omega_vm, mu_s=mu_s, scale_mode=scale_mode,
        cover=gram.wgram_cover)
    E1 = mu_full.shape[1]
    G = Gk.T.reshape(batch, E1, E1)
    SA = SAk.T.reshape(batch, 3, E1)
    r = rk.T
    Sb = Sbk.T
    W = Wk[0]

    if tj_lm is not None:
        # The per-call joints block in the same centred variables (P4 - mu;
        # the scale column -tj or p_j minus mu_s).
        p_j, P4 = pre['p_j'], pre['P4']
        bJ = tj_lm - p_j  # (3, J, B)
        P4c = P4 - mu[:, :, None, :]
        if scale_mode:
            col_j = (-tj_lm if scale_target else p_j) - mu_s[:, None, :]
            P4c = torch.cat([P4c, col_j[:, None]], dim=1)  # (3, E1, J, B)
        P4w = P4c * jw_lm[None, None]
        G = G + torch.einsum('aejb,afjb->bef', P4w, P4c)
        r = r + torch.einsum('aejb,ajb->be', P4w, bJ)
        SA = SA + torch.einsum('aejb,jb->bae', P4c, jw_lm)
        Sb = Sb + torch.einsum('ajb,jb->ba', bJ, jw_lm)
        W = W + jw_lm.sum(dim=0)

    return _solve_tail(plan, gram, pre, G, SA, r, Sb, W, beta_regularizer, beta_regularizer2,
                       kid_regularizer, beta_regularizer_reference, kid_regularizer_reference,
                       requested_keys, homog_vm, scale_target, scale_fit, scale_regularizer,
                       trans_shift_jac=mu_full.permute(2, 0, 1), share_beta=share_beta,
                       batch_mask=batch_mask)


def lbs_recon_spec_lm(bm, plan, gram: GramData, glob_lm, x_T):
    """Reconstruction operands of a known shape ``x_T`` (E, B) (betas, and the
    kid factor when the plan has it) under rotations glob_lm (9, J, B): the
    per-part-sum spec (as the solve's ``recon_spec``, without the posed-template
    cache), the model joints (3, J, B) and sum_v rec_v (3, B), the latter
    contracted from the first moments ``Kc`` and ``W1`` without the mesh."""
    E = gram.n_ext
    pre = _fk_ext_prelude(bm, plan, glob_lm)
    p_j = pre['p_j'] + torch.einsum('aejb,eb->ajb', pre['P4'], x_T)
    t2 = pre['t_lm'] + sum(pre['T4'][:, e] * x_T[e][None, None] for e in range(E))
    pj_cm = torch.stack(
        [glob_lm[a * 3 + c] if c < 3 else t2[a] for a in range(3) for c in range(4)])
    feat_cols = torch.cat([pre['feat_cols'], x_T], dim=0)
    spec = dict(pj_cm=pj_cm, feat_cols=feat_cols, weights_pad=gram.weights_pad,
                consts_pad=gram.consts_full, homog_vm=None, cover=gram.wgram_cover)
    # sum_v rec_v[a] = sum_j R_j[a, :] . (Kc_j @ feat) + W1_j t2[a, j]
    kq = torch.einsum('jcf,fb->cjb', gram.Kc, feat_cols)
    w1 = gram.W1_col[:, 0]
    rec_sum = torch.stack([
        sum((glob_lm[a * 3 + c] * kq[c]).sum(dim=0) for c in range(3))
        + torch.einsum('j,jb->b', w1, t2[a])
        for a in range(3)
    ])
    return spec, p_j, rec_sum
