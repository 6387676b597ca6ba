"""Synthetic SMPL-family model files for license-free testing and benchmarking.

The official model files are not redistributable, so the tests and
``chip_smoke.py`` run on synthetic models (SMPL, SMPL-X, SMPL+H, MANO) with
the exact file format, skeleton topology and tensor shapes of the real ones
(configurable vertex count). This is the model writer of
``smplfitter_tpu.utils.synthetic``, copied so that the PyTorch package imports
without JAX; the tests hold both writers to identical files.

The geometry is a plausible stick-figure body: joints at anthropometric
positions, vertices scattered along the bones, skinning weights dominated by
the nearest joint.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np

# Parent indices of the SMPL-family kinematic trees (public convention; joint
# name order as in modeldata.JOINT_NAMES_BY_MODEL).
SMPL_PARENTS = [
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21,
]


def _hand_parents(wrist: int, start: int) -> list[int]:
    """Parents of the 15 hand joints (5 fingers x 3 segments) rooted at wrist."""
    parents = []
    for finger in range(5):
        parents += [wrist, start + finger * 3, start + finger * 3 + 1]
    return parents


SMPLH_PARENTS = SMPL_PARENTS[:22] + _hand_parents(20, 22) + _hand_parents(21, 37)
SMPLX_PARENTS = (
    SMPL_PARENTS[:22] + [15, 15, 15] + _hand_parents(20, 25) + _hand_parents(21, 40)
)
MANO_PARENTS = [-1] + _hand_parents(0, 1)
MANO_NUM_VERTICES = 778

_BODY_JOINT_POS = np.array(
    [
        [0.00, 0.00, 0.00],   # pelvis
        [0.09, -0.07, 0.00],  # left_hip
        [-0.09, -0.07, 0.00], # right_hip
        [0.00, 0.11, 0.00],   # spine1
        [0.10, -0.45, 0.00],  # left_knee
        [-0.10, -0.45, 0.00], # right_knee
        [0.00, 0.25, 0.00],   # spine2
        [0.09, -0.84, -0.03], # left_ankle
        [-0.09, -0.84, -0.03],# right_ankle
        [0.00, 0.30, 0.00],   # spine3
        [0.11, -0.90, 0.10],  # left_foot
        [-0.11, -0.90, 0.10], # right_foot
        [0.00, 0.45, 0.00],   # neck
        [0.07, 0.40, 0.00],   # left_collar
        [-0.07, 0.40, 0.00],  # right_collar
        [0.00, 0.55, 0.02],   # head
        [0.17, 0.42, 0.00],   # left_shoulder
        [-0.17, 0.42, 0.00],  # right_shoulder
        [0.43, 0.41, 0.00],   # left_elbow
        [-0.43, 0.41, 0.00],  # right_elbow
        [0.68, 0.40, 0.00],   # left_wrist
        [-0.68, 0.40, 0.00],  # right_wrist
        [0.76, 0.40, 0.00],   # left_hand
        [-0.76, 0.40, 0.00],  # right_hand
    ]
)


def _hand_joint_pos(wrist_pos: np.ndarray, side: float) -> np.ndarray:
    """15 finger joints extending from the wrist along +-x."""
    pos = []
    for finger in range(5):
        y_off = (finger - 2) * 0.015
        for seg in range(3):
            pos.append(
                wrist_pos + np.array([side * (0.035 + 0.025 * seg), y_off, 0.01 * finger - 0.02])
            )
    return np.array(pos)


def skeleton(model_name: str):
    """Return (parents, joint_positions) for a synthetic model variant."""
    if model_name == 'smpl':
        return list(SMPL_PARENTS), _BODY_JOINT_POS.copy()
    if model_name in ('smplh', 'smplh16'):
        pos = np.concatenate(
            [
                _BODY_JOINT_POS[:22],
                _hand_joint_pos(_BODY_JOINT_POS[20], +1.0),
                _hand_joint_pos(_BODY_JOINT_POS[21], -1.0),
            ]
        )
        return list(SMPLH_PARENTS), pos
    if model_name in ('smplx', 'smplxlh', 'smplxmoyo'):
        head = _BODY_JOINT_POS[15]
        face = np.array([head + [0.0, -0.04, 0.06], head + [0.03, 0.02, 0.07],
                         head + [-0.03, 0.02, 0.07]])
        pos = np.concatenate(
            [
                _BODY_JOINT_POS[:22],
                face,
                _hand_joint_pos(_BODY_JOINT_POS[20], +1.0),
                _hand_joint_pos(_BODY_JOINT_POS[21], -1.0),
            ]
        )
        return list(SMPLX_PARENTS), pos
    if model_name == 'mano':
        wrist = np.zeros(3)
        pos = np.concatenate([wrist[None], _hand_joint_pos(wrist, +1.0)])
        return list(MANO_PARENTS), pos
    raise ValueError(f'Unknown model name: {model_name}')


def make_raw_model(
    model_name: str = 'smpl',
    num_vertices: int = 768,
    num_betas: int = 10,
    seed: int = 0,
):
    """Build a raw model dict in the official file layout (pre-normalization)."""
    parents, jpos = skeleton(model_name)
    J = len(parents)
    V = num_vertices
    rng = np.random.default_rng(seed + 1000 * J + V)

    # Round-robin part assignment guarantees every part has vertices.
    assign = np.arange(V) % J
    parent_arr = np.array([p if p >= 0 else 0 for p in parents])
    spread = np.where(np.arange(J) < 22, 0.05, 0.012) if J > 24 else np.full(J, 0.05)

    u = rng.uniform(0.15, 1.0, size=V)[:, None]
    base = jpos[parent_arr[assign]] * (1 - u) + jpos[assign] * u
    v_template = base + rng.normal(0, 1, size=(V, 3)) * spread[assign][:, None]

    # Skinning weights dominated by the assigned joint (argmax == assign).
    weights = np.zeros((V, J))
    weights[np.arange(V), assign] = 0.75
    weights[np.arange(V), parent_arr[assign]] += 0.20
    grandparent = parent_arr[parent_arr[assign]]
    weights[np.arange(V), grandparent] += 0.05
    weights /= weights.sum(axis=1, keepdims=True)

    # Pre-LBS joint regressor: convex weights over the nearest vertices.
    J_regressor = np.zeros((J, V))
    for j in range(J):
        d2 = np.sum((v_template - jpos[j]) ** 2, axis=1)
        nearest = np.argsort(d2)[:16]
        w = np.exp(-d2[nearest] / (2 * 0.03**2) )
        w = np.maximum(w, 1e-6)
        J_regressor[j, nearest] = w / w.sum()

    # Shape blendshapes: smooth low-frequency fields (mix of global modes).
    n_modes = 6
    freqs = rng.normal(0, 2.0, size=(n_modes, 3))
    phases = rng.uniform(0, 2 * np.pi, size=n_modes)
    basis = np.sin(v_template @ freqs.T + phases)  # (V, n_modes)
    mode_mix = rng.normal(0, 1, size=(n_modes, 3, num_betas))
    shapedirs = np.einsum('vm,mcs->vcs', basis, mode_mix) * 0.02
    # beta0 ~ height stretch (y only — deliberately NOT uniform scale, so the
    # scale_target/scale_fit estimation stays identifiable in tests).
    shapedirs[:, 1, 0] += v_template[:, 1] * 0.05

    # Pose correctives: small, random but smooth.
    P = (J - 1) * 9
    pose_mix = rng.normal(0, 1, size=(n_modes, 3, P))
    posedirs = np.einsum('vm,mcp->vcp', basis, pose_mix) * 0.002

    faces = rng.integers(0, V, size=(2 * V, 3)).astype(np.int32)

    kintree_table = np.stack(
        [np.array(parents, dtype=np.int64), np.arange(J, dtype=np.int64)]
    )

    raw = dict(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=J_regressor,
        weights=weights,
        f=faces,
        kintree_table=kintree_table,
    )

    # Kid template: scaled-down body with smooth perturbation (SMIL-like).
    kid_template = v_template * 0.67 + basis[:, :3] @ rng.normal(0, 0.01, size=(3, 3))
    return raw, kid_template


def write_model_files(
    body_models_dir: str,
    model_name: str = 'smpl',
    num_vertices: int = 768,
    num_betas: int = 10,
    seed: int = 0,
    genders: tuple = ('neutral',),
) -> str:
    """Write synthetic model files in the official on-disk format.

    Returns the model_root directory.
    """
    from .modeldata import model_filename

    model_root = osp.join(body_models_dir, model_name)
    os.makedirs(model_root, exist_ok=True)
    raw, kid_template = make_raw_model(model_name, num_vertices, num_betas, seed)

    for gender in genders:
        filename = model_filename(model_name, gender)
        filepath = osp.join(model_root, filename)
        os.makedirs(osp.dirname(filepath), exist_ok=True)
        if filename.endswith('.npz'):
            np.savez(filepath, **raw)
        else:
            with open(filepath, 'wb') as f:
                pickle.dump(raw, f)

    if model_name.lower().startswith('smpl'):
        np.save(osp.join(model_root, 'kid_template.npy'), kid_template)
    return model_root


def _nearest3(v_in: np.ndarray, v_out: np.ndarray, chunk: int = 512):
    """For each row of ``v_out``: indices + inverse-distance weights of its 3
    nearest rows in ``v_in``, a chunk of rows at a time."""
    idx = np.empty((len(v_out), 3), np.int64)
    w = np.empty((len(v_out), 3))
    for s0 in range(0, len(v_out), chunk):
        blk = v_out[s0:s0 + chunk]
        d2 = ((blk[:, None, :] - v_in[None, :, :]) ** 2).sum(-1)
        near = np.argpartition(d2, 3, axis=1)[:, :3]
        dn = np.take_along_axis(d2, near, axis=1)
        ww = 1.0 / np.sqrt(dn + 1e-6)
        idx[s0:s0 + chunk] = near
        w[s0:s0 + chunk] = ww / ww.sum(axis=1, keepdims=True)
    return idx, w


def write_deftrafo(
    body_models_dir: str,
    num_verts_in: int,
    num_verts_out: int,
    v_template_in: np.ndarray,
    v_template_out: np.ndarray,
    filename: str,
) -> str:
    """Write a synthetic barycentric vertex-transfer pickle (deftrafo format).

    Each output vertex is a convex combination of its 3 nearest input vertices.
    The stored matrix has 2x the input columns with the right half zero, matching
    the official deftrafo layout (the loader keeps the left half).
    """
    import scipy.sparse

    idx, w = _nearest3(v_template_in, v_template_out)
    rows = np.repeat(np.arange(num_verts_out), 3)
    mtx = scipy.sparse.coo_matrix(
        (w.reshape(-1), (rows, idx.reshape(-1))),
        shape=(num_verts_out, 2 * num_verts_in),
    ).tocsr()
    path = osp.join(body_models_dir, filename)
    with open(path, 'wb') as f:
        pickle.dump(dict(mtx=mtx), f)
    return path


def ensure_cached_models(
    cache_dir: str | None = None,
    num_vertices_smpl: int = 6890,
    num_vertices_smplx: int = 10475,
    full: bool = False,
) -> str:
    """Write (once) and return a cached synthetic body_models directory at
    real tensor shapes: SMPL (V=6890, 10 betas), SMPL-X (V=10475, 16 betas),
    SMPL+H ``smplh16`` (the SMPL vertex count, 16 betas) by default, and MANO
    (V=778, 10 betas). ``full`` also writes the applications' assets, as
    :func:`write_full_test_environment` does: the SMPL <-> SMPL-X deftrafo
    pickles, the SMPL-X flip correspondences and the hand vertex ids."""
    if cache_dir is None:
        cache_dir = os.path.join(
            os.path.expanduser('~'), '.cache', 'smplfitter_tpu_torch',
            f'synthetic_v{num_vertices_smpl}_{num_vertices_smplx}' + ('_full' if full else ''),
        )
    marker = osp.join(cache_dir, '.complete')
    if not osp.exists(marker):
        if full:
            write_full_test_environment(cache_dir, num_vertices_smpl, num_vertices_smplx)
        else:
            write_model_files(cache_dir, 'smpl', num_vertices_smpl)
            write_model_files(cache_dir, 'smplx', num_vertices_smplx, num_betas=16)
            write_model_files(cache_dir, 'smplh16', num_vertices_smpl, num_betas=16)
        write_model_files(cache_dir, 'mano', MANO_NUM_VERTICES)
        with open(marker, 'w') as f:
            f.write('ok')
    return cache_dir


def write_full_test_environment(
    body_models_dir: str,
    num_vertices_smpl: int = 768,
    num_vertices_smplx: int = 1024,
    seed: int = 0,
) -> str:
    """Write a complete synthetic body_models directory: smpl, smplx, smplh16,
    the smpl<->smplx deftrafo transfer setups, and flip correspondences.

    Point SMPLFITTER_BODY_MODELS here, and DATA_ROOT at its parent (the
    applications read ``$DATA_ROOT/body_models/...``), so name the directory
    ``body_models``.
    """
    os.makedirs(body_models_dir, exist_ok=True)
    write_model_files(body_models_dir, 'smpl', num_vertices_smpl, seed=seed)
    write_model_files(body_models_dir, 'smplx', num_vertices_smplx, num_betas=16, seed=seed)
    write_model_files(body_models_dir, 'smplh16', num_vertices_smpl, num_betas=16, seed=seed)

    from .modeldata import initialize

    smpl = initialize('smpl', 'neutral', osp.join(body_models_dir, 'smpl'))
    smplx = initialize('smplx', 'neutral', osp.join(body_models_dir, 'smplx'))
    write_deftrafo(
        body_models_dir, smpl.num_vertices, smplx.num_vertices,
        smpl.v_template, smplx.v_template, 'smpl2smplx_deftrafo_setup.pkl',
    )
    write_deftrafo(
        body_models_dir, smplx.num_vertices, smpl.num_vertices,
        smplx.v_template, smpl.v_template, 'smplx2smpl_deftrafo_setup.pkl',
    )

    # Flip correspondences for smplx: nearest mirrored vertex, barycentric over
    # one face triple (format: closest_faces (V, 3) + bc (V, 3)).
    v = smplx.v_template
    mirrored = v * np.array([-1.0, 1.0, 1.0])
    closest, bc = _nearest3(v, mirrored)
    np.savez(
        osp.join(body_models_dir, 'smplx', 'smplx_flip_correspondences.npz'),
        closest_faces=closest,
        bc=bc,
    )

    # Hand vertex ids (MANO<->SMPLX correspondence format): the smplx vertices
    # whose dominant skinning weight is a hand joint (25..54).
    assign = np.argmax(smplx.weights, axis=1)
    left_ids = np.where((assign >= 25) & (assign < 40))[0].astype(np.int64)
    right_ids = np.where((assign >= 40) & (assign < 55))[0].astype(np.int64)
    with open(osp.join(body_models_dir, 'smplx', 'MANO_SMPLX_vertex_ids.pkl'), 'wb') as f:
        pickle.dump(dict(left_hand=left_ids, right_hand=right_ids), f)
    return body_models_dir
