"""The port's applications against the JAX package on the CPU: the loader and
synthetic-asset copies, the mirror maps, the vertex transfer and hand blend,
``BodyConverter.convert`` (its three routes, with and without a kid factor,
SMPL -> SMPL-X and back), ``BodyFlipper.flip`` and ``HandReplacer.replace_hand``.

The synthetic full environment of the suite (SMPL V=432, SMPL-X V=660,
``smplh16`` V=432, the deftrafo pickles, the SMPL-X flip correspondences and
hand vertex ids), inputs from a numpy seed, B = 4. Limits:
- the loader and writer copies: equal, array for array;
- the mirror CSR and the Hungarian mirror maps: equal;
- the vertex transfer, the flipped vertices and rotvecs, smootherstep, the
  hand mask and ``copy_hand_params``: within 1e-6 (GATHER_ATOL);
- fits whose output model is SMPL: ``bench.py``'s gate, max|d betas, kid| <=
  1e-3 and the mean reconstruction errors within 0.01 mm of each other;
- fits whose output model is SMPL-X, and the hand replacer's ``smplh16`` fit
  (its output vertices): the larger of that gate and 4x the output's own
  spread, the largest change of the output over 3 seeded 1e-7 relative
  changes of the inputs, on the JAX package and on the port alike (the
  converter's SMPL-X fit, unregularized, moves its betas by ~0.05 under such
  a change: an ill-conditioned fit, not a port fault).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smplfitter_tpu
import smplfitter_tpu_torch
from port_on_cpu import port_model_from
from smplfitter_tpu.models import bodyflipper as jax_flip
from smplfitter_tpu.models import handreplacer as jax_hand
from smplfitter_tpu.utils import modeldata as jax_md
from smplfitter_tpu.utils import synthetic as jax_synth
from smplfitter_tpu_torch.models import bodyflipper as port_flip
from smplfitter_tpu_torch.models import handreplacer as port_hand
from smplfitter_tpu_torch.utils import modeldata as port_md
from smplfitter_tpu_torch.utils import synthetic as port_synth

GATHER_ATOL = 1e-6
BETA_ATOL = 1e-3
V2V_MM = 0.01
NOISE_SEEDS = 3
NOISE_REL = 1e-7
SPREAD_MULT = 4
BATCH = 4
# model -> (joints, betas) of the synthetic models
SHAPES = {'smpl': (24, 10), 'smplx': (55, 16), 'smplh16': (52, 16)}


@pytest.fixture(scope='module')
def models(body_models_dir):
    out = {}
    for name in SHAPES:
        jax_bm = smplfitter_tpu.BodyModel(name, 'neutral')
        out[name] = (jax_bm, port_model_from(jax_bm))
    return out


@pytest.fixture(scope='module')
def converters(models):
    pairs = {'smpl2smplx': ('smpl', 'smplx'), 'smplx2smpl': ('smplx', 'smpl')}
    return {key: (smplfitter_tpu.BodyConverter(models[a][0], models[b][0]),
                  smplfitter_tpu_torch.BodyConverter(models[a][1], models[b][1]))
            for key, (a, b) in pairs.items()}


@pytest.fixture(scope='module')
def flippers(models):
    return (smplfitter_tpu.BodyFlipper(models['smpl'][0]),
            smplfitter_tpu_torch.BodyFlipper(models['smpl'][1]))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _params(model, batch, seed, pose_std=0.2):
    rng = np.random.default_rng(seed)
    J, S = SHAPES[model]
    return (rng.normal(0, pose_std, (batch, 3 * J)).astype(np.float32),
            rng.normal(0, 1, (batch, S)).astype(np.float32),
            rng.normal(0, 0.5, (batch, 3)).astype(np.float32),
            rng.normal(0, 0.5, (batch,)).astype(np.float32))


def _perturbed(arrays, seed):
    rng = np.random.default_rng(1000 + seed)
    return [None if a is None else (a * (1 + NOISE_REL * rng.normal(size=a.shape))).astype(
        np.float32) for a in arrays]


def _own_spread(run, arrays, base, measure):
    """The largest change of ``measure(result, base)`` over NOISE_SEEDS seeded
    1e-7 relative changes of the input arrays."""
    return max(measure(run(*_perturbed(arrays, seed)), base) for seed in range(NOISE_SEEDS))


# --- loader and synthetic-asset copies ---------------------------------------


def _assets(d):
    return {osp.relpath(osp.join(root, f), d)
            for root, _, files in os.walk(d) for f in files}


def _load_any(path):
    if path.endswith('.npz'):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith('.npy'):
        return {'': np.load(path)}
    with open(path, 'rb') as f:
        obj = pickle.load(f)
    return {k: (v.toarray() if hasattr(v, 'toarray') else np.asarray(v)) for k, v in obj.items()}


def test_full_environment_writer_matches_jax(tmp_path):
    jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jax_synth.write_full_test_environment(jax_dir, 200, 300, seed=3)
    port_synth.write_full_test_environment(port_dir, 200, 300, seed=3)
    files = _assets(jax_dir)
    assert files == _assets(port_dir)
    assert {'smpl2smplx_deftrafo_setup.pkl', 'smplx2smpl_deftrafo_setup.pkl',
            'smplx/smplx_flip_correspondences.npz', 'smplx/MANO_SMPLX_vertex_ids.pkl'} <= files
    for rel in sorted(files):
        ours, theirs = _load_any(osp.join(port_dir, rel)), _load_any(osp.join(jax_dir, rel))
        assert ours.keys() == theirs.keys(), rel
        for key in theirs:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=f'{rel} {key}')


def test_ensure_cached_models_full_writes_the_assets(tmp_path):
    d = port_synth.ensure_cached_models(str(tmp_path / 'body_models'), 200, 300, full=True)
    assert {'smpl2smplx_deftrafo_setup.pkl', 'smplx/smplx_flip_correspondences.npz',
            'smplx/MANO_SMPLX_vertex_ids.pkl', 'mano/MANO_RIGHT.pkl'} <= _assets(d)


@pytest.mark.parametrize('name', ['smpl2smplx_deftrafo_setup.pkl',
                                  'smplx2smpl_deftrafo_setup.pkl'])
def test_vertex_converter_loader_matches_jax(body_models_dir, name):
    path = osp.join(body_models_dir, name)
    raw_ours, raw_theirs = port_md.load_pickle(path), jax_md.load_pickle(path)
    assert (raw_ours['mtx'] != raw_theirs['mtx']).nnz == 0
    ours, theirs = port_md.load_vertex_converter_csr(path), jax_md.load_vertex_converter_csr(path)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert (ours != theirs).nnz == 0
    for a, b in zip(port_md.csr_to_dense_gather(ours), jax_md.csr_to_dense_gather(theirs)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_hand_vertex_ids_loader_matches_jax(body_models_dir):
    path = osp.join(body_models_dir, 'smplx', 'MANO_SMPLX_vertex_ids.pkl')
    ours, theirs = port_md.load_pickle(path), jax_md.load_pickle(path)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key])


# --- mirror maps, gathers and the hand blend ---------------------------------


@pytest.mark.parametrize('model', ['smpl', 'smplx'])
def test_mirror_csr_matches_jax(models, model):
    V = models[model][0].num_vertices
    ours, theirs = port_flip.get_mirror_csr(V), jax_flip.get_mirror_csr(V)
    assert ours.shape == theirs.shape == (V, V)
    np.testing.assert_allclose(ours.toarray(), theirs.toarray(), atol=0, rtol=0)


def test_mirror_mappings_match_jax(flippers):
    theirs, ours = flippers
    np.testing.assert_array_equal(_np(ours.mirror_inds), np.asarray(theirs.mirror_inds))
    np.testing.assert_array_equal(_np(ours.mirror_inds_joints),
                                  np.asarray(theirs.mirror_inds_joints))
    points = np.random.default_rng(5).normal(size=(50, 3))
    np.testing.assert_array_equal(port_flip.get_mirror_mapping(points),
                                  jax_flip.get_mirror_mapping(points))


@pytest.mark.parametrize('key', ['smpl2smplx', 'smplx2smpl'])
def test_vertex_converter_matches_jax(models, converters, key):
    theirs, ours = converters[key]
    V_in = ours.body_model_in.num_vertices
    verts = np.random.default_rng(6).normal(size=(BATCH, V_in, 3)).astype(np.float32)
    got = _np(ours.convert_vertices(verts))
    assert got.shape == (BATCH, ours.body_model_out.num_vertices, 3)
    np.testing.assert_allclose(got, np.asarray(theirs.convert_vertices(verts)),
                               atol=GATHER_ATOL, rtol=0)
    k = ours.vertex_converter.indices.shape[1]
    assert ours.vertex_converter.weights.shape[1] == k


def test_same_topology_convert_vertices_is_identity(models):
    conv = smplfitter_tpu_torch.BodyConverter(models['smpl'][1], models['smplh16'][1])
    assert conv.vertex_converter is None
    verts = torch.randn(2, models['smpl'][1].num_vertices, 3)
    assert torch.equal(conv.convert_vertices(verts), verts)


def test_flip_vertices_and_rotvecs_match_jax(models, flippers):
    theirs, ours = flippers
    jax_bm = models['smpl'][0]
    pose, betas, trans, _ = _params('smpl', BATCH, 7)
    verts = np.asarray(jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)['vertices'])
    np.testing.assert_allclose(_np(ours.flip_vertices(verts)),
                               np.asarray(theirs.flip_vertices(verts)), atol=GATHER_ATOL, rtol=0)
    flipped = _np(ours.naive_flip_rotvecs(pose))
    np.testing.assert_allclose(flipped, np.asarray(theirs.naive_flip_rotvecs(pose)),
                               atol=GATHER_ATOL, rtol=0)
    np.testing.assert_allclose(_np(ours.naive_flip_rotvecs(flipped)), pose, atol=GATHER_ATOL,
                               rtol=0)


def test_smootherstep_matches_jax():
    x = np.linspace(-0.5, 1.5, 101).astype(np.float32)
    np.testing.assert_allclose(_np(port_hand.smootherstep(torch.as_tensor(x), 0.1, 0.9)),
                               np.asarray(jax_hand.smootherstep(x, 0.1, 0.9)),
                               atol=GATHER_ATOL, rtol=0)


@pytest.fixture(scope='module')
def replacers(models):
    hand_pose = np.random.default_rng(8).normal(0, 0.2, (52 * 3,)).astype(np.float32)
    jax_bm, bm = models['smplh16']
    return (smplfitter_tpu.HandReplacer(hand_pose, smplh_model=jax_bm),
            smplfitter_tpu_torch.HandReplacer(hand_pose, smplh_model=bm))


def test_hand_mask_and_params_match_jax(replacers):
    theirs, ours = replacers
    np.testing.assert_array_equal(ours.hand_indices_all, theirs.hand_indices_all)
    assert ours.hand_indices_all.size > 0
    np.testing.assert_allclose(_np(ours.vertex_weights), np.asarray(theirs.vertex_weights),
                               atol=0, rtol=0)
    np.testing.assert_allclose(_np(ours.hand_mix_weight), np.asarray(theirs.hand_mix_weight),
                               atol=GATHER_ATOL, rtol=0)
    pose = np.random.default_rng(9).normal(0, 0.1, (BATCH, 52 * 3)).astype(np.float32)
    pose_t = torch.as_tensor(pose)
    got = ours.copy_hand_params(pose_t)
    assert torch.equal(pose_t, torch.as_tensor(pose))  # the input is left as it was
    np.testing.assert_allclose(_np(got), np.asarray(theirs.copy_hand_params(jnp.asarray(pose))),
                               atol=GATHER_ATOL, rtol=0)


def test_hand_replacer_builds_on_the_card_by_default(body_models_dir):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        smplfitter_tpu_torch.HandReplacer(np.zeros(156, np.float32))


# --- fits --------------------------------------------------------------------


def _recon_v2v_mm(bm, res, target, known=None):
    """Mean distance (mm) of the port CPU model's mesh of a result (with the
    known pose or shape filled in) to the target vertices."""
    p = dict(known or {}, **{k: torch.as_tensor(np.array(_np(v))) for k, v in res.items()})
    out = bm(pose_rotvecs=p['pose_rotvecs'], shape_betas=p['shape_betas'], trans=p['trans'],
             kid_factor=p.get('kid_factor'))
    return float((out['vertices'] - torch.as_tensor(_np(target))).norm(dim=-1).mean()) * 1e3


def _max_dshape(a, b):
    keys = [k for k in ('shape_betas', 'kid_factor') if k in b]
    return max((float(np.abs(_np(a[k]) - _np(b[k])).max()) for k in keys), default=0.0)


def _hold_fit(ours, theirs, run_ours, run_theirs, inputs, bm, target, spread_rule, known=None):
    """A fit result of the port against the JAX package's under the gate
    stated in the module docstring."""
    assert ours.keys() == theirs.keys()
    v2v_ours = _recon_v2v_mm(bm, ours, target, known)
    v2v_theirs = _recon_v2v_mm(bm, theirs, target, known)
    beta_limit, v2v_limit = BETA_ATOL, V2V_MM
    if spread_rule:
        spread = max(_own_spread(run, inputs, base, _max_dshape)
                     for run, base in ((run_ours, ours), (run_theirs, theirs)))
        v2v_spread = max(
            _own_spread(run, inputs, base,
                        lambda r, b: abs(_recon_v2v_mm(bm, r, target, known)
                                         - _recon_v2v_mm(bm, b, target, known)))
            for run, base in ((run_ours, ours), (run_theirs, theirs)))
        beta_limit = max(beta_limit, SPREAD_MULT * spread)
        v2v_limit = max(v2v_limit, SPREAD_MULT * v2v_spread)
    assert _max_dshape(ours, theirs) <= beta_limit
    assert abs(v2v_ours - v2v_theirs) <= v2v_limit, (v2v_ours, v2v_theirs, v2v_limit)
    for value in ours.values():
        assert torch.isfinite(value).all()


ROUTES = ['free', 'known_shape', 'known_pose']


@pytest.mark.parametrize('kid', [False, True])
@pytest.mark.parametrize('route', ROUTES)
@pytest.mark.parametrize('key', ['smpl2smplx', 'smplx2smpl'])
def test_convert_matches_jax(models, converters, key, route, kid):
    theirs_conv, ours_conv = converters[key]
    model_in, model_out = key.split('2')
    seed = 20 + 6 * ['smpl2smplx', 'smplx2smpl'].index(key) + 2 * ROUTES.index(route) + kid
    pose, betas, trans, kid_factor = _params(model_in, BATCH, seed)
    out_pose, out_betas, _, out_kid = _params(model_out, BATCH, seed + 100, pose_std=0.1)
    # The known output pose or shape is an input too: the spread changes it.
    known = dict(known_shape=[out_betas, out_kid if kid else None],
                 known_pose=[out_pose], free=[])[route]

    def runner(conv):
        def run(pose, betas, trans, kid_factor, *known):
            extra = {}
            if route == 'known_shape':
                extra = dict(known_output_shape_betas=known[0], known_output_kid_factor=known[1])
            elif route == 'known_pose':
                extra = dict(known_output_pose_rotvecs=known[0])
            return conv.convert(pose, betas, trans, kid_factor=kid_factor if kid else None,
                                **extra)
        return run

    inputs = [pose, betas, trans, kid_factor, *known]
    ours, theirs = runner(ours_conv)(*inputs), runner(theirs_conv)(*inputs)
    target = ours_conv.convert_vertices(
        models[model_in][1](pose, betas, trans, kid_factor if kid else None)['vertices'])
    names = dict(known_shape=['shape_betas', 'kid_factor'], known_pose=['pose_rotvecs'],
                 free=[])[route]
    known = {k: torch.as_tensor(v) for k, v in zip(names, known) if v is not None}
    _hold_fit(ours, theirs, runner(ours_conv), runner(theirs_conv), inputs,
              models[model_out][1], target, spread_rule=model_out != 'smpl', known=known)


@pytest.mark.parametrize('kid', [False, True])
def test_flip_matches_jax(models, flippers, kid):
    theirs_flip, ours_flip = flippers
    pose, betas, trans, kid_factor = _params('smpl', BATCH, 40 + kid)

    def runner(flipper):
        def run(pose, betas, trans, kid_factor):
            return flipper.flip(pose, betas, trans, kid_factor if kid else None, num_iter=2)
        return run

    inputs = [pose, betas, trans, kid_factor]
    ours, theirs = runner(ours_flip)(*inputs), runner(theirs_flip)(*inputs)
    bm = models['smpl'][1]
    target = ours_flip.flip_vertices(bm(pose, betas, trans, kid_factor if kid else None)['vertices'])
    _hold_fit(ours, theirs, None, None, inputs, bm, target, spread_rule=False)


def test_replace_hand_matches_jax(models, replacers):
    theirs, ours = replacers
    jax_bm = models['smplh16'][0]
    pose, betas, trans, _ = _params('smplh16', BATCH, 50, pose_std=0.1)
    verts = np.asarray(jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)['vertices'])
    got, want = ours.replace_hand(verts), theirs.replace_hand(verts)
    assert tuple(got.shape) == verts.shape and torch.isfinite(got).all()

    def dist(a, b):
        return float(np.abs(_np(a) - _np(b)).max())

    spread = max(_own_spread(r.replace_hand, [verts], base, dist)
                 for r, base in ((ours, got), (theirs, want)))
    assert dist(got, want) <= max(BETA_ATOL, SPREAD_MULT * spread)
    # Far from the hands (where the synthetic mesh has such vertices) the mesh
    # is the input's.
    body = _np(ours.hand_mix_weight) == 0
    np.testing.assert_allclose(_np(got)[:, body], verts[:, body], atol=GATHER_ATOL, rtol=0)
