"""Loading and normalization of SMPL-family body model files.

Host-side (NumPy) layer: everything here runs once at construction time and
produces plain ``np.ndarray``s that the PyTorch model layer converts to device
tensors. This is a copy of ``smplfitter_tpu.utils.modeldata`` (the loader part),
kept here so that the PyTorch package imports without JAX; the tests hold the
two loaders to identical arrays. Semantics mirror the reference loader
(the original SMPLFitter ``common.py``): filename/gender mapping for
all seven model variants, chumpy-free unpickling of official .pkl files,
scipy.sparse forward-compat, kid-blendshape construction, derivation of
J_template/J_shapedirs when absent, the pose-blendshape zero-point correction,
and vertex-subset slicing.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import pickle
import sys
import types
from dataclasses import dataclass

import numpy as np

# Joint name registries (public SMPL-family conventions, cf.
# the original SMPLFitter ``common.py``).
SMPL_JOINT_NAMES = [
    'pelvis', 'left_hip', 'right_hip', 'spine1', 'left_knee', 'right_knee',
    'spine2', 'left_ankle', 'right_ankle', 'spine3', 'left_foot', 'right_foot',
    'neck', 'left_collar', 'right_collar', 'head', 'left_shoulder',
    'right_shoulder', 'left_elbow', 'right_elbow', 'left_wrist', 'right_wrist',
    'left_hand', 'right_hand',
]

_HAND_JOINT_NAMES = [
    f'{finger}{i}'
    for finger in ['index', 'middle', 'pinky', 'ring', 'thumb']
    for i in (1, 2, 3)
]

SMPLH_JOINT_NAMES = (
    SMPL_JOINT_NAMES[:22]
    + [f'left_{n}' for n in _HAND_JOINT_NAMES]
    + [f'right_{n}' for n in _HAND_JOINT_NAMES]
)

SMPLX_JOINT_NAMES = (
    SMPL_JOINT_NAMES[:22]
    + ['jaw', 'left_eye_smplhf', 'right_eye_smplhf']
    + [f'left_{n}' for n in _HAND_JOINT_NAMES]
    + [f'right_{n}' for n in _HAND_JOINT_NAMES]
)

MANO_JOINT_NAMES = ['wrist'] + _HAND_JOINT_NAMES

JOINT_NAMES_BY_MODEL = {
    'smpl': SMPL_JOINT_NAMES,
    'smplx': SMPLX_JOINT_NAMES,
    'smplxlh': SMPLX_JOINT_NAMES,
    'smplxmoyo': SMPLX_JOINT_NAMES,
    'smplh': SMPLH_JOINT_NAMES,
    'smplh16': SMPLH_JOINT_NAMES,
    'mano': MANO_JOINT_NAMES,
}

GENDER_MAPS = {
    'smpl': dict(f='f', m='m', n='neutral'),
    'smplx': dict(f='FEMALE', m='MALE', n='NEUTRAL'),
    'smplxlh': dict(f='FEMALE', m='MALE', n='NEUTRAL'),
    'smplxmoyo': dict(f='FEMALE', m='MALE', n='NEUTRAL'),
    'smplh': dict(f='female', m='male'),
    'smplh16': dict(f='female', m='male', n='neutral'),
    'mano': {},
}


@dataclass
class ModelData:
    """All arrays and metadata needed to instantiate a body model."""

    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, S)
    posedirs: np.ndarray  # (V, 3, (J-1)*9)
    J_regressor_post_lbs: np.ndarray  # (J, V)
    J_template: np.ndarray  # (J, 3)
    J_shapedirs: np.ndarray  # (J, 3, S)
    kid_shapedir: np.ndarray  # (V, 3)
    kid_J_shapedir: np.ndarray  # (J, 3)
    weights: np.ndarray  # (V, J)
    kintree_parents: list  # len J
    faces: np.ndarray
    num_joints: int
    num_vertices: int
    vertex_subset: np.ndarray
    joint_names: list


def resolve_body_models_dir() -> str:
    """Resolve the body-models directory from env vars, like the reference.

    Order: $SMPLFITTER_BODY_MODELS, then $DATA_ROOT/body_models, then
    ./body_models if it exists, then the platform-appropriate per-user data
    directory (as the original SMPLFitter loader does).
    """
    body_models_dir = os.getenv('SMPLFITTER_BODY_MODELS')
    if body_models_dir is not None:
        return body_models_dir
    data_root = os.getenv('DATA_ROOT')
    if data_root is not None:
        return osp.join(data_root, 'body_models')
    if osp.isdir('body_models'):
        return 'body_models'
    try:
        import platformdirs
    except ImportError:
        return 'body_models'
    return osp.join(platformdirs.user_data_dir('smplfitter'), 'body_models')


def model_filename(model_name: str, gender: str) -> str:
    gmap = GENDER_MAPS.get(model_name)
    if gmap is None:
        raise ValueError(f'Unknown model name: {model_name}')
    if model_name != 'mano':
        key = gender[0].lower()
        if key not in gmap:
            available = [{'f': 'female', 'm': 'male', 'n': 'neutral'}[k] for k in gmap]
            raise ValueError(
                f"Gender '{gender}' is not available for model '{model_name}'. "
                f"Available: {', '.join(repr(g) for g in available)}."
            )
        gender_str = gmap[key]
    if model_name == 'smpl':
        return f'basicmodel_{gender_str}_lbs_10_207_0_v1.1.0.pkl'
    elif model_name in ('smplx', 'smplxlh', 'smplxmoyo'):
        return f'SMPLX_{gender_str}.npz'
    elif model_name == 'smplh':
        return f'SMPLH_{gender_str}.pkl'
    elif model_name == 'smplh16':
        return osp.join(gender_str, 'model.npz')
    elif model_name == 'mano':
        return 'MANO_RIGHT.pkl'
    raise ValueError(f'Unknown model name: {model_name}')


def initialize(
    model_name: str = 'smpl',
    gender: str = 'neutral',
    model_root: str | None = None,
    num_betas: int | None = None,
    vertex_subset_size: int | None = None,
    vertex_subset: np.ndarray | None = None,
    faces: np.ndarray | None = None,
    joint_regressor_post_lbs: np.ndarray | None = None,
) -> ModelData:
    """Load and normalize a body model file into a :class:`ModelData`."""
    if model_root is None:
        model_root = osp.join(resolve_body_models_dir(), model_name)

    filename = model_filename(model_name, gender)
    filepath = osp.join(model_root, filename)
    try:
        if filename.endswith('.npz'):
            raw = dict(np.load(filepath))
        else:
            with open(filepath, 'rb') as f, chumpy_stub_modules(), scipy_sparse_forward_compat():
                raw = pickle.load(f, encoding='latin1')
    except FileNotFoundError:
        raise FileNotFoundError(
            f'Body model file not found: {filepath}\n'
            f'Point smplfitter_tpu_torch at your model files via one of:\n'
            f"  1. BodyModel('{model_name}', '{gender}', model_root=...)\n"
            f'  2. export SMPLFITTER_BODY_MODELS=/your/path/body_models\n'
            f'  3. export DATA_ROOT=/your/path  (uses $DATA_ROOT/body_models/)\n'
            f'Models must be obtained from the official MPI sites '
            f'(smpl/smpl-x/mano .is.tue.mpg.de); they are not redistributable.'
        ) from None

    res: dict = {}
    res['shapedirs'] = np.asarray(raw['shapedirs'], dtype=np.float64)
    res['posedirs'] = np.asarray(raw['posedirs'], dtype=np.float64)
    res['v_template'] = np.asarray(raw['v_template'], dtype=np.float64)

    j_reg = raw['J_regressor']
    if not isinstance(j_reg, np.ndarray):
        j_reg = j_reg.toarray()
    res['J_regressor'] = np.asarray(j_reg, dtype=np.float64)

    res['weights'] = np.asarray(raw['weights'], dtype=np.float64)
    res['faces'] = np.asarray(raw['f']).astype(np.int32)
    res['kintree_parents'] = np.asarray(raw['kintree_table'][0], dtype=np.int32).tolist()
    num_joints = len(res['kintree_parents'])
    num_vertices = len(res['v_template'])

    # Kid blendshape pulls the mesh towards the (mean-centered) SMIL template.
    if model_name.lower().startswith('smpl'):
        kid_path = osp.join(model_root, 'kid_template.npy')
        try:
            v_template_smil = np.load(kid_path).astype(np.float64)
        except FileNotFoundError:
            raise FileNotFoundError(
                f'Kid template not found: {kid_path}\n'
                f'Obtain it from the AGORA project (agora.is.tue.mpg.de).'
            ) from None
        res['kid_shapedir'] = (
            v_template_smil - np.mean(v_template_smil, axis=0) - res['v_template']
        )
        res['kid_J_shapedir'] = res['J_regressor'] @ res['kid_shapedir']
    else:
        res['kid_shapedir'] = np.zeros_like(res['v_template'])
        res['kid_J_shapedir'] = np.zeros((num_joints, 3))

    if 'J_shapedirs' in raw:
        res['J_shapedirs'] = np.asarray(raw['J_shapedirs'], dtype=np.float64)
    else:
        res['J_shapedirs'] = np.einsum('jv,vcs->jcs', res['J_regressor'], res['shapedirs'])

    if 'J_template' in raw:
        res['J_template'] = np.asarray(raw['J_template'], dtype=np.float64)
    else:
        res['J_template'] = res['J_regressor'] @ res['v_template']

    # Pose-blendshape zero-point correction: shift v_template so the pose feature
    # can be the raw flattened rotation matrices instead of (R - I)
    # (as the original SMPLFitter loader does).
    res['v_template'] = res['v_template'] - np.einsum(
        'vcx,x->vc',
        res['posedirs'],
        np.tile(np.eye(3, dtype=np.float64), [num_joints - 1, 1]).reshape(-1),
    )

    if vertex_subset_size is not None:
        subset_path = osp.join(model_root, f'vertex_subset_{vertex_subset_size}.npz')
        if not osp.exists(subset_path):
            from .decimation import decimate

            i_verts, dec_faces = decimate(res['v_template'], res['faces'], vertex_subset_size)
            np.savez(subset_path, i_verts=i_verts, faces=dec_faces)
        subset_dict = np.load(subset_path)
        vertex_subset = subset_dict['i_verts']
        faces = subset_dict['faces']
        regressor_path = osp.join(
            model_root, f'vertex_subset_joint_regr_post_lbs_{vertex_subset_size}.npy'
        )
        if osp.exists(regressor_path):
            joint_regressor_post_lbs = np.load(regressor_path)
        else:
            joint_regressor_post_lbs = res['J_regressor'][:, vertex_subset]

    if vertex_subset is None:
        vertex_subset = np.arange(num_vertices, dtype=np.int64)
    else:
        vertex_subset = np.asarray(vertex_subset, dtype=np.int64)

    if faces is None:
        faces = res['faces']

    if joint_regressor_post_lbs is None:
        # The joints are regressed from the subset's vertices. (The JAX
        # loader keeps the full regressor for an explicit subset, so its fits
        # without target joints cannot regress joints from the subset mesh.)
        joint_regressor_post_lbs = res['J_regressor'][:, vertex_subset]

    return ModelData(
        v_template=res['v_template'][vertex_subset],
        shapedirs=res['shapedirs'][vertex_subset, :, :num_betas],
        posedirs=res['posedirs'][vertex_subset],
        J_regressor_post_lbs=np.asarray(joint_regressor_post_lbs, dtype=np.float64),
        J_template=res['J_template'],
        J_shapedirs=res['J_shapedirs'][:, :, :num_betas],
        kid_shapedir=res['kid_shapedir'][vertex_subset],
        kid_J_shapedir=res['kid_J_shapedir'],
        weights=res['weights'][vertex_subset],
        kintree_parents=res['kintree_parents'],
        faces=faces,
        num_joints=num_joints,
        num_vertices=len(vertex_subset),
        vertex_subset=vertex_subset,
        joint_names=JOINT_NAMES_BY_MODEL.get(model_name, []),
    )


def load_pickle(path: str):
    with open(path, 'rb') as f, scipy_sparse_forward_compat():
        return pickle.load(f, encoding='latin1')


def load_vertex_converter_csr(vertex_converter_path: str):
    """Load a barycentric vertex-transfer sparse matrix (scipy CSR).

    The stored matrix has twice the needed columns; only the left half is used.
    """
    scipy_csr = load_pickle(vertex_converter_path)['mtx'].tocsr().astype(np.float32)
    return scipy_csr[:, : scipy_csr.shape[1] // 2]


def csr_to_dense_gather(csr, max_nnz_per_row: int | None = None):
    """Convert a scipy CSR matrix to fixed-width gather form (indices, weights).

    Barycentric transfer rows have at most ~3 nonzeros, so the sparse product
    becomes a dense (rows, k) gather and a weighted sum over k on the device.
    Rows with fewer than k nonzeros are padded with index 0 and weight 0.

    Returns (indices (rows, k) int32, weights (rows, k) float32).
    """
    csr = csr.tocsr()
    nnz_per_row = np.diff(csr.indptr)
    k = int(nnz_per_row.max()) if max_nnz_per_row is None else max_nnz_per_row
    rows = csr.shape[0]
    indices = np.zeros((rows, k), dtype=np.int32)
    weights = np.zeros((rows, k), dtype=np.float32)
    for r in range(rows):
        start, end = csr.indptr[r], csr.indptr[r + 1]
        n = min(end - start, k)
        indices[r, :n] = csr.indices[start : start + n]
        weights[r, :n] = csr.data[start : start + n]
    return indices, weights


@contextlib.contextmanager
def _temporary_modules(entries: dict):
    """Install ``entries`` into ``sys.modules`` for the duration of the block,
    restoring whatever (if anything) was there before."""
    displaced = {name: sys.modules.get(name) for name in entries}
    sys.modules.update(entries)
    try:
        yield
    finally:
        for name, previous in displaced.items():
            if previous is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = previous


def scipy_sparse_forward_compat():
    """Unpickle files naming removed ``scipy.sparse.{coo,csr,csc}`` submodules
    (deftrafo pickles predate their removal) by aliasing them to the package."""
    import scipy.sparse

    return _temporary_modules(
        {f'scipy.sparse.{sub}': scipy.sparse for sub in ('coo', 'csr', 'csc')}
    )


class _UnpickledChumpyArray:
    """Shape-shifts into whatever chumpy class pickle assigns attributes to;
    ``__array__`` recovers the plain ndarray. Covers ``chumpy.ch.Ch`` (data in
    ``.x``) and ``chumpy.reordering.Select`` (flat-index view ``.a[.idxs]``,
    optionally reshaped to ``.preferred_shape``) — the two chumpy types that
    appear in the official SMPL-family .pkl files."""

    def __array__(self, dtype=None):
        if hasattr(self, 'x'):
            return np.array(self.x, dtype=dtype)
        picked = np.array(self.a, dtype=dtype).ravel()[self.idxs]
        shape = getattr(self, 'preferred_shape', None)
        return picked if shape is None else picked.reshape(shape)


def chumpy_stub_modules():
    """Unpickle official .pkl files without chumpy installed: fake modules whose
    ``Ch``/``Select`` classes are array-convertible attribute bags."""
    fakes = {name: types.ModuleType(name)
             for name in ('chumpy', 'chumpy.ch', 'chumpy.reordering')}
    fakes['chumpy.ch'].Ch = _UnpickledChumpyArray
    fakes['chumpy.reordering'].Select = _UnpickledChumpyArray
    return _temporary_modules(fakes)
