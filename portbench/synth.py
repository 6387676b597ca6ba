"""The benchmark's frozen writer of synthetic SMPL-family model files.

The official model files are licensed downloads, so every configuration runs
on a synthetic model at the published tensor shapes: the SMPL-family file
layout, skeleton and widths, with random weights from the configuration's
seed (3 nonzero skinning weights per vertex). This writer is the benchmark's
own copy, kept apart from the program's so that a change to the program can
never change the yardstick's models.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile

import numpy as np

SMPL_PARENTS = [
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21,
]


def _hand_parents(wrist: int, start: int) -> list[int]:
    """Parents of the 15 hand joints (5 fingers x 3 segments) rooted at wrist."""
    parents = []
    for finger in range(5):
        parents += [wrist, start + finger * 3, start + finger * 3 + 1]
    return parents


SMPLX_PARENTS = (
    SMPL_PARENTS[:22] + [15, 15, 15] + _hand_parents(20, 25) + _hand_parents(21, 40)
)

_BODY_JOINT_POS = np.array([
    [0.00, 0.00, 0.00], [0.09, -0.07, 0.00], [-0.09, -0.07, 0.00], [0.00, 0.11, 0.00],
    [0.10, -0.45, 0.00], [-0.10, -0.45, 0.00], [0.00, 0.25, 0.00], [0.09, -0.84, -0.03],
    [-0.09, -0.84, -0.03], [0.00, 0.30, 0.00], [0.11, -0.90, 0.10], [-0.11, -0.90, 0.10],
    [0.00, 0.45, 0.00], [0.07, 0.40, 0.00], [-0.07, 0.40, 0.00], [0.00, 0.55, 0.02],
    [0.17, 0.42, 0.00], [-0.17, 0.42, 0.00], [0.43, 0.41, 0.00], [-0.43, 0.41, 0.00],
    [0.68, 0.40, 0.00], [-0.68, 0.40, 0.00], [0.76, 0.40, 0.00], [-0.76, 0.40, 0.00],
])

# Official file names of the neutral models, relative to the model's directory.
FILE_NAMES = {'smpl': 'basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl',
              'smplx': 'SMPLX_NEUTRAL.npz'}


def _hand_joint_pos(wrist_pos: np.ndarray, side: float) -> np.ndarray:
    pos = []
    for finger in range(5):
        y_off = (finger - 2) * 0.015
        for seg in range(3):
            pos.append(wrist_pos + np.array(
                [side * (0.035 + 0.025 * seg), y_off, 0.01 * finger - 0.02]))
    return np.array(pos)


def skeleton(model: str):
    """(parents, rest joint positions) of a model's skeleton."""
    if model == 'smpl':
        return list(SMPL_PARENTS), _BODY_JOINT_POS.copy()
    if model == 'smplx':
        head = _BODY_JOINT_POS[15]
        face = np.array([head + [0.0, -0.04, 0.06], head + [0.03, 0.02, 0.07],
                         head + [-0.03, 0.02, 0.07]])
        pos = np.concatenate([_BODY_JOINT_POS[:22], face,
                              _hand_joint_pos(_BODY_JOINT_POS[20], +1.0),
                              _hand_joint_pos(_BODY_JOINT_POS[21], -1.0)])
        return list(SMPLX_PARENTS), pos
    raise ValueError(f'no synthetic skeleton for model {model!r}')


def make_raw_model(model: str, num_vertices: int, num_betas: int, seed: int):
    """A raw model dict in the official file layout, and the kid template."""
    parents, jpos = skeleton(model)
    J = len(parents)
    V = num_vertices
    rng = np.random.default_rng(seed + 1000 * J + V)

    assign = np.arange(V) % J
    parent_arr = np.array([p if p >= 0 else 0 for p in parents])
    spread = np.where(np.arange(J) < 22, 0.05, 0.012) if J > 24 else np.full(J, 0.05)
    u = rng.uniform(0.15, 1.0, size=V)[:, None]
    base = jpos[parent_arr[assign]] * (1 - u) + jpos[assign] * u
    v_template = base + rng.normal(0, 1, size=(V, 3)) * spread[assign][:, None]

    weights = np.zeros((V, J))
    weights[np.arange(V), assign] = 0.75
    weights[np.arange(V), parent_arr[assign]] += 0.20
    weights[np.arange(V), parent_arr[parent_arr[assign]]] += 0.05
    weights /= weights.sum(axis=1, keepdims=True)

    J_regressor = np.zeros((J, V))
    for j in range(J):
        d2 = np.sum((v_template - jpos[j]) ** 2, axis=1)
        nearest = np.argsort(d2)[:16]
        w = np.maximum(np.exp(-d2[nearest] / (2 * 0.03 ** 2)), 1e-6)
        J_regressor[j, nearest] = w / w.sum()

    n_modes = 6
    freqs = rng.normal(0, 2.0, size=(n_modes, 3))
    phases = rng.uniform(0, 2 * np.pi, size=n_modes)
    basis = np.sin(v_template @ freqs.T + phases)
    mode_mix = rng.normal(0, 1, size=(n_modes, 3, num_betas))
    shapedirs = np.einsum('vm,mcs->vcs', basis, mode_mix) * 0.02
    shapedirs[:, 1, 0] += v_template[:, 1] * 0.05
    pose_mix = rng.normal(0, 1, size=(n_modes, 3, (J - 1) * 9))
    posedirs = np.einsum('vm,mcp->vcp', basis, pose_mix) * 0.002
    faces = rng.integers(0, V, size=(2 * V, 3)).astype(np.int32)
    kintree_table = np.stack([np.array(parents, dtype=np.int64), np.arange(J, dtype=np.int64)])
    raw = dict(v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
               J_regressor=J_regressor, weights=weights, f=faces, kintree_table=kintree_table)
    kid_template = v_template * 0.67 + basis[:, :3] @ rng.normal(0, 0.01, size=(3, 3))
    return raw, kid_template


def model_dir(cache_root: str, config: dict) -> str:
    """The directory of a configuration's model files under ``cache_root``,
    written once: the directory the program's loader reads as ``model_root``."""
    return os.path.join(cache_root, config['name'], config['model'])


def ensure_model_files(cache_root: str, config: dict) -> str:
    """Write the configuration's model files under ``cache_root`` unless a
    complete set for this configuration is there; return their directory.
    A set is complete when its marker holds the configuration it was made
    from, so an edited configuration writes its files anew."""
    root = model_dir(cache_root, config)
    marker = os.path.join(root, 'complete.json')
    stamp = json.dumps(config, sort_keys=True)
    if os.path.isfile(marker):
        with open(marker) as f:
            if f.read() == stamp:
                return root
    shutil.rmtree(root, ignore_errors=True)
    # Written into a staging directory of its own and moved into place whole,
    # so that processes writing the same set at once never see half of one.
    os.makedirs(os.path.dirname(root), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=config['model'] + '.partial.', dir=os.path.dirname(root))
    raw, kid = make_raw_model(config['model'], config['num_vertices'], config['num_betas'],
                              config['synthetic_seed'])
    path = os.path.join(tmp, FILE_NAMES[config['model']])
    if path.endswith('.npz'):
        np.savez(path, **raw)
    else:
        with open(path, 'wb') as f:
            pickle.dump(raw, f)
    np.save(os.path.join(tmp, 'kid_template.npy'), kid)
    with open(os.path.join(tmp, 'complete.json'), 'w') as f:
        f.write(stamp)
    try:
        os.replace(tmp, root)
    except OSError:
        # Another process put a set in place first: it was made from the same
        # configuration and seed, so this one is dropped.
        shutil.rmtree(tmp, ignore_errors=True)
    return root
