"""Vertex subsets of a body model's mesh (decimation), in numpy.

A copy of ``smplfitter_tpu.utils.decimation`` for the port, which imports
nothing of the JAX package. It makes the ``vertex_subset_{n}.npz`` files
(indices into the original vertices and the subset's faces) that
``BodyModel(vertex_subset_size=n)`` loads: by trimesh's quadric decimation
matched back to original vertices where trimesh is installed, else by
farthest-point sampling, which keeps every body part covered (what the
fitter needs of a subset).
"""

from __future__ import annotations

import numpy as np


def farthest_point_sampling(points: np.ndarray, n_samples: int, seed: int = 0):
    """Greedy farthest-point subset of ``points`` (V, 3) -> sorted indices (n_samples,)."""
    V = len(points)
    if n_samples >= V:
        return np.arange(V, dtype=np.int64)
    rng = np.random.default_rng(seed)
    chosen = np.empty(n_samples, dtype=np.int64)
    chosen[0] = rng.integers(V)
    d2 = np.sum((points - points[chosen[0]]) ** 2, axis=1)
    for i in range(1, n_samples):
        chosen[i] = int(np.argmax(d2))
        d2 = np.minimum(d2, np.sum((points - points[chosen[i]]) ** 2, axis=1))
    return np.sort(chosen)


def _faces_for_subset(faces: np.ndarray, subset: np.ndarray, points: np.ndarray):
    """Faces remapped onto the subset, each corner snapped to its nearest
    subset vertex; degenerate triangles dropped, duplicates merged."""
    sub_pts = points[subset]
    nearest = np.empty(len(points), dtype=np.int64)
    chunk = 4096  # bounds the (chunk, n_subset, 3) distance block
    for start in range(0, len(points), chunk):
        d2 = np.sum((points[start:start + chunk, None] - sub_pts[None]) ** 2, axis=-1)
        nearest[start:start + chunk] = np.argmin(d2, axis=1)
    remapped = nearest[faces]
    keep = ((remapped[:, 0] != remapped[:, 1]) & (remapped[:, 1] != remapped[:, 2])
            & (remapped[:, 0] != remapped[:, 2]))
    return np.unique(remapped[keep], axis=0).astype(np.int32)


def decimate(v_template: np.ndarray, faces: np.ndarray, target_count: int):
    """``target_count`` vertices of the template and faces over them:
    (indices into the original vertices (target_count,), faces (F', 3) over
    subset indices). Trimesh's quadric decimation where trimesh imports, else
    farthest-point sampling (seed 0)."""
    try:
        return _decimate_trimesh(v_template, faces, target_count)
    except ImportError:
        subset = farthest_point_sampling(np.asarray(v_template, np.float64), target_count)
        dec_faces = _faces_for_subset(np.asarray(faces), subset, np.asarray(v_template))
        return subset, dec_faces


def _decimate_trimesh(v_template, faces, target_count):
    import scipy.optimize
    import scipy.spatial.distance
    import trimesh

    mesh = trimesh.Trimesh(vertices=np.asarray(v_template), faces=np.asarray(faces))
    # Quadric decimation targets a face count: raise it until the decimated
    # mesh has at least the target's vertices, then match them to originals.
    n_faces = int(target_count * 2.1)
    for _ in range(30):
        dec = mesh.simplify_quadric_decimation(face_count=n_faces)
        if len(dec.vertices) >= target_count:
            break
        n_faces = int(n_faces * 1.1) + 8
    else:
        raise RuntimeError('decimation failed to reach the target vertex count')

    dist = scipy.spatial.distance.cdist(dec.vertices, mesh.vertices)
    _, orig_ids = scipy.optimize.linear_sum_assignment(dist)
    orig_ids = orig_ids[:len(dec.vertices)]
    order = np.argsort(orig_ids)
    subset = np.asarray(orig_ids)[order][:target_count]
    inverse = np.empty(len(dec.vertices), dtype=np.int64)
    inverse[order] = np.arange(len(dec.vertices))
    dec_faces = inverse[np.asarray(dec.faces)]
    dec_faces = dec_faces[(dec_faces < target_count).all(axis=1)].astype(np.int32)
    return subset.astype(np.int64), dec_faces
