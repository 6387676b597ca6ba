"""The port's host-side copies and its BodyModel against the JAX package.

The loader and the synthetic writer are copies, so they must produce
identical arrays. The forward pass is held to the JAX ``BodyModel`` (its XLA
formulation on the CPU) within 2e-5 x the output's scale: both are f32, the
port computes the LBS as one fused twin with another summation order.
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np
import pytest
import torch

from port_on_cpu import port_model, port_model_from
from smplfitter_tpu import BodyModel as JaxBodyModel
from smplfitter_tpu.utils import modeldata as jax_modeldata
from smplfitter_tpu.utils import synthetic as jax_synthetic
from smplfitter_tpu_torch.utils import modeldata as port_modeldata
from smplfitter_tpu_torch.utils import synthetic as port_synthetic

REL_TOL = 2e-5
ARRAY_FIELDS = ('v_template', 'shapedirs', 'posedirs', 'J_regressor_post_lbs', 'J_template',
                'J_shapedirs', 'kid_shapedir', 'kid_J_shapedir', 'weights', 'faces',
                'vertex_subset')


@pytest.mark.parametrize('num_betas', [None, 6])
def test_loader_copy_matches_original(body_models_dir, num_betas):
    ours = port_modeldata.initialize('smpl', 'neutral', num_betas=num_betas)
    theirs = jax_modeldata.initialize('smpl', 'neutral', num_betas=num_betas)
    for field in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field), err_msg=field)
    assert ours.kintree_parents == theirs.kintree_parents
    assert (ours.num_joints, ours.num_vertices) == (theirs.num_joints, theirs.num_vertices)
    assert ours.joint_names == theirs.joint_names


def test_model_filename_and_dir_resolution(body_models_dir):
    for gender in ('neutral', 'f', 'male'):
        assert (port_modeldata.model_filename('smpl', gender)
                == jax_modeldata.model_filename('smpl', gender))
    assert port_modeldata.resolve_body_models_dir() == jax_modeldata.resolve_body_models_dir()
    with pytest.raises(ValueError):
        port_modeldata.model_filename('smplh', 'neutral')


def test_synthetic_writer_matches_original(tmp_path):
    ours = port_synthetic.write_model_files(str(tmp_path / 'ours'), 'smpl', 300, seed=3)
    theirs = jax_synthetic.write_model_files(str(tmp_path / 'theirs'), 'smpl', 300, seed=3)
    name = jax_modeldata.model_filename('smpl', 'neutral')
    with open(osp.join(ours, name), 'rb') as f:
        raw_ours = pickle.load(f)
    with open(osp.join(theirs, name), 'rb') as f:
        raw_theirs = pickle.load(f)
    assert raw_ours.keys() == raw_theirs.keys()
    for key in raw_ours:
        np.testing.assert_array_equal(raw_ours[key], raw_theirs[key], err_msg=key)
    np.testing.assert_array_equal(np.load(osp.join(ours, 'kid_template.npy')),
                                  np.load(osp.join(theirs, 'kid_template.npy')))


def test_ensure_cached_models_writes_once(tmp_path):
    d = port_synthetic.ensure_cached_models(str(tmp_path / 'cache'), num_vertices_smpl=200)
    data = port_modeldata.initialize('smpl', 'neutral', osp.join(d, 'smpl'))
    assert data.num_vertices == 200 and data.num_joints == 24
    assert port_synthetic.ensure_cached_models(str(tmp_path / 'cache'), 200) == d


@pytest.fixture(scope='module')
def both_models(body_models_dir):
    jax_bm = JaxBodyModel('smpl', 'neutral')
    return jax_bm, port_model_from(jax_bm)


def _assert_close(ours, theirs):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=REL_TOL * max(np.max(np.abs(theirs)), 1.0))


@pytest.mark.parametrize('batch,n_betas', [(8, 10), (5, 4)])
def test_forward_matches_jax(both_models, batch, n_betas):
    jax_bm, bm = both_models
    rng = np.random.default_rng(batch)
    pose = rng.normal(0, 0.3, (batch, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, n_betas)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    ours = bm(pose, betas, trans)
    theirs = jax_bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    assert set(ours) == set(theirs)
    for key in ours:
        assert ours[key].shape == tuple(theirs[key].shape), key
        _assert_close(ours[key], theirs[key])


def test_forward_defaults_match_jax(both_models):
    """No pose (identity rotations), a kid factor, no translation."""
    jax_bm, bm = both_models
    betas = np.random.default_rng(1).normal(0, 1, (3, 10)).astype(np.float32)
    kid = np.array([0.0, 0.5, 1.0], np.float32)
    ours = bm(shape_betas=betas, kid_factor=kid)
    theirs = jax_bm(shape_betas=betas, kid_factor=kid)
    for key in ours:
        _assert_close(ours[key], theirs[key])


def test_model_loads_by_name_like_from_model_data(both_models):
    _, bm = both_models
    loaded = port_model('smpl', 'neutral')
    for name, buf in bm.named_buffers():
        assert torch.equal(buf, getattr(loaded, name)), name
    assert loaded.lbs_consts.shape == (4, 512, 207 + 1 + 10 + 1)
    assert loaded.lbs_weights_pad.shape == (512, 24)
