"""Offline tests of the port's copy of the downloader (``smplfitter_tpu_torch.download``).

The archive cases of ``tests/test_download.py`` through the port's copy, its
synthetic raw models and its loader: fake archives with the official
internal nesting are installed by the member-flattening installer, and the
port's ``utils.modeldata`` loads every model from the installed tree. Every
member name of those cases gets the same destination from both packages'
layout rules, and every (model, gender) the port's loader resolves has a
producer.
"""

from __future__ import annotations

import io
import os
import os.path as osp
import pickle
import tarfile
import zipfile

import numpy as np
import pytest

from smplfitter_tpu import download as jax_download
from smplfitter_tpu_torch import download
from smplfitter_tpu_torch.utils import synthetic
from smplfitter_tpu_torch.utils.modeldata import GENDER_MAPS, initialize, model_filename

SMPL_MEMBERS = {
    'SMPL_python_v.1.1.0/smpl/models/basicmodel_f_lbs_10_207_0_v1.1.0.pkl': 'smpl',
    'SMPL_python_v.1.1.0/smpl/models/basicmodel_m_lbs_10_207_0_v1.1.0.pkl': 'smpl',
    'SMPL_python_v.1.1.0/smpl/models/basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl': 'smpl',
    'SMPL_python_v.1.1.0/smpl/smpl_webuser/serialization.py': b'# code',
    'SMPL_python_v.1.1.0/models/readme.txt': b'readme',
}
SMPLX_MEMBERS = {f'models/smplx/SMPLX_{g}.npz': 'smplx' for g in ('NEUTRAL', 'MALE', 'FEMALE')}
SMPLX_MEMBERS['models/smplx/version.txt'] = b'v1.1'
SMPLXLH_MEMBERS = {f'SMPLX_{g}.npz': 'smplx' for g in ('NEUTRAL', 'MALE', 'FEMALE')}
FLIP_MEMBERS = {'smplx_flip_correspondences.npz': b'npzdata'}
HAND_ID_MEMBERS = {'MANO_SMPLX_vertex_ids.pkl': b'pkl', 'SMPL-X__FLAME_vertex_ids.npy': b'npy',
                   'readme.txt': b'txt'}
TRANSFER_MEMBERS = {'transfer_data/smpl2smplx_deftrafo_setup.pkl': b'a',
                    'transfer_data/smplx2smpl_deftrafo_setup.pkl': b'b',
                    'transfer_data/meshes/readme.md': b'c'}
MANO_MEMBERS = {
    'mano_v1_2/models/MANO_LEFT.pkl': 'mano',
    'mano_v1_2/models/MANO_RIGHT.pkl': 'mano',
    'mano_v1_2/models/SMPLH_female.pkl': 'smplh',
    'mano_v1_2/models/SMPLH_male.pkl': 'smplh',
    'mano_v1_2/models/info.txt': b'info',
    'mano_v1_2/webuser/verts.py': b'# code',
}
SMPLH16_MEMBERS = {f'smplh/{g}/model.npz': 'smplh16' for g in ('male', 'female', 'neutral')}
SMPLH16_MEMBERS['smplh/LICENSE.txt'] = b'license'
# remote file -> the member names of its archive in these cases
MEMBERS = {
    'SMPL_python_v.1.1.0.zip': SMPL_MEMBERS,
    'models_smplx_v1_1.zip': SMPLX_MEMBERS,
    'smplx_lockedhead_20230207.zip': SMPLXLH_MEMBERS,
    'smplx_flip_correspondences.zip': FLIP_MEMBERS,
    'smplx_mano_flame_correspondences.zip': HAND_ID_MEMBERS,
    'model_transfer.zip': TRANSFER_MEMBERS,
    'mano_v1_2.zip': MANO_MEMBERS,
    'smplh.tar.xz': SMPLH16_MEMBERS,
}


def _raw_bytes(model_name, num_vertices=96, num_betas=4):
    raw, _kid = synthetic.make_raw_model(model_name, num_vertices, num_betas)
    buf = io.BytesIO()
    if model_name in ('smplx', 'smplh16'):
        np.savez(buf, **raw)
    else:
        pickle.dump(raw, buf)
    return buf.getvalue()


def _contents(members):
    """Member name -> bytes: a model name stands for that model's raw file."""
    return {name: _raw_bytes(v) if isinstance(v, str) else v for name, v in members.items()}


def _write_zip(path, members):
    with zipfile.ZipFile(path, 'w') as zf:
        for name, data in members.items():
            zf.writestr(name, data)


def _write_tar_xz(path, members):
    with tarfile.open(path, 'w:xz') as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _find_asset(module, remote_file):
    (asset,) = [a for a in module.ARCHIVES if a.remote_file == remote_file]
    return asset


@pytest.fixture()
def target(tmp_path):
    d = tmp_path / 'body_models'
    d.mkdir()
    return str(d)


def _install(tmp_path, target, remote_file):
    asset = _find_asset(download, remote_file)
    archive = str(tmp_path / osp.basename(remote_file))
    writer = _write_tar_xz if remote_file.endswith('.tar.xz') else _write_zip
    writer(archive, _contents(MEMBERS[remote_file]))
    installed = download.install_archive(archive, asset.layout, target)
    download.create_symlinks(asset.symlinks, target)
    return asset, installed


@pytest.mark.parametrize('remote_file', list(MEMBERS))
def test_layouts_match_jax_package(remote_file):
    ours = _find_asset(download, remote_file)
    theirs = _find_asset(jax_download, remote_file)
    assert ours.domain == theirs.domain
    assert ours.done_markers == theirs.done_markers and ours.symlinks == theirs.symlinks
    for member in MEMBERS[remote_file]:
        assert ours.layout(member) == theirs.layout(member), member
    assert [(f.domain, f.remote_file, f.dest, f.symlinks) for f in download.FILES] == [
        (f.domain, f.remote_file, f.dest, f.symlinks) for f in jax_download.FILES]


def test_smpl_zip_layout(tmp_path, target):
    asset, installed = _install(tmp_path, target, 'SMPL_python_v.1.1.0.zip')
    assert sorted(installed) == [
        'smpl/basicmodel_f_lbs_10_207_0_v1.1.0.pkl',
        'smpl/basicmodel_m_lbs_10_207_0_v1.1.0.pkl',
        'smpl/basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl',
    ]
    assert download.is_installed(asset, target)
    for link in ('SMPL_MALE.pkl', 'SMPL_FEMALE.pkl', 'SMPL_NEUTRAL.pkl'):
        assert osp.exists(osp.join(target, 'smpl', link))
    np.save(osp.join(target, 'smpl', 'kid_template.npy'), np.zeros((96, 3)))
    for gender in ('female', 'male', 'neutral'):
        assert osp.exists(osp.join(target, 'smpl', model_filename('smpl', gender)))
        md = initialize('smpl', gender, osp.join(target, 'smpl'))
        assert md.num_joints == 24 and md.num_vertices == 96


def test_smplx_zips_layout(tmp_path, target):
    _, installed = _install(tmp_path, target, 'models_smplx_v1_1.zip')
    assert len(installed) == 3
    _install(tmp_path, target, 'smplx_lockedhead_20230207.zip')
    for name in ('smplx', 'smplxlh'):
        np.save(osp.join(target, name, 'kid_template.npy'), np.zeros((96, 3)))
        assert initialize(name, 'neutral', osp.join(target, name)).num_joints == 55


def test_smplx_auxiliary_archives(tmp_path, target):
    _install(tmp_path, target, 'smplx_flip_correspondences.zip')
    assert osp.exists(osp.join(target, 'smplx', 'smplx_flip_correspondences.npz'))
    _install(tmp_path, target, 'smplx_mano_flame_correspondences.zip')
    assert osp.exists(osp.join(target, 'smplx', 'MANO_SMPLX_vertex_ids.pkl'))
    assert osp.exists(osp.join(target, 'smplx', 'SMPL-X__FLAME_vertex_ids.npy'))
    assert not osp.exists(osp.join(target, 'smplx', 'readme.txt'))
    _install(tmp_path, target, 'model_transfer.zip')
    # The deftrafo setups land at the body_models root, where the converter looks.
    assert osp.exists(osp.join(target, 'smpl2smplx_deftrafo_setup.pkl'))
    assert osp.exists(osp.join(target, 'smplx2smpl_deftrafo_setup.pkl'))


def test_mano_package_serves_both_families(tmp_path, target):
    asset, _ = _install(tmp_path, target, 'mano_v1_2.zip')
    assert download.is_installed(asset, target)
    assert osp.exists(osp.join(target, 'smplh', 'SMPLH_FEMALE.pkl'))  # symlink
    assert initialize('mano', 'neutral', osp.join(target, 'mano')).num_joints == 16
    np.save(osp.join(target, 'smplh', 'kid_template.npy'), np.zeros((96, 3)))
    assert initialize('smplh', 'female', osp.join(target, 'smplh')).num_joints == 52


def test_smplh16_tar_layout(tmp_path, target):
    asset, installed = _install(tmp_path, target, 'smplh.tar.xz')
    assert sorted(installed) == ['smplh16/female/model.npz', 'smplh16/male/model.npz',
                                 'smplh16/neutral/model.npz']
    assert download.is_installed(asset, target)
    np.save(osp.join(target, 'smplh16', 'kid_template.npy'), np.zeros((96, 3)))
    for gender in ('female', 'male', 'neutral'):
        assert initialize('smplh16', gender, osp.join(target, 'smplh16')).num_joints == 52


def test_kid_template_symlinks(target):
    for d in ('smpl', 'smplh16', 'smplxlh'):
        os.makedirs(osp.join(target, d))
    np.save(osp.join(target, 'smpl', 'kid_template.npy'), np.zeros((9, 3)))
    for fasset in download.FILES:
        if osp.exists(osp.join(target, fasset.dest)):
            download.create_symlinks(fasset.symlinks, target)
    assert osp.exists(osp.join(target, 'smplh16', 'kid_template.npy'))
    # No smplxlh link: its target (the SMPL-X template) does not exist.
    assert not osp.lexists(osp.join(target, 'smplxlh', 'kid_template.npy'))


def test_idempotency_markers(target):
    asset = _find_asset(download, 'SMPL_python_v.1.1.0.zip')
    assert not download.is_installed(asset, target)
    for marker in asset.done_markers:
        path = osp.join(target, marker)
        os.makedirs(osp.dirname(path), exist_ok=True)
        with open(path, 'wb') as f:
            f.write(b'x')
    assert download.is_installed(asset, target)


def test_resolve_target_dir_reads_the_port_loader(monkeypatch, tmp_path):
    monkeypatch.setenv('SMPLFITTER_BODY_MODELS', str(tmp_path))
    assert download.resolve_target_dir(None) == osp.abspath(str(tmp_path))
    assert download.resolve_target_dir('given') == 'given'


def _long(gender_str):
    return {'f': 'female', 'm': 'male', 'neutral': 'neutral', 'FEMALE': 'female',
            'MALE': 'male', 'NEUTRAL': 'neutral', 'female': 'female', 'male': 'male',
            '': 'neutral'}[gender_str]


def test_every_loader_path_has_a_producer():
    """Every (model, gender) the port's loader resolves is produced by some
    archive's layout rule."""
    official_member = {
        'smpl': 'SMPL_python_v.1.1.0/smpl/models/basicmodel_{g}_lbs_10_207_0_v1.1.0.pkl',
        'smplx': 'models/smplx/SMPLX_{g}.npz',
        'smplxlh': 'SMPLX_{g}.npz',
        'smplh': 'mano_v1_2/models/SMPLH_{g}.pkl',
        'smplh16': 'smplh/{g}/model.npz',
        'mano': 'mano_v1_2/models/MANO_RIGHT.pkl',
    }
    layouts = {a.remote_file: a.layout for a in download.ARCHIVES}
    layout_for = {
        'smpl': layouts['SMPL_python_v.1.1.0.zip'],
        'smplx': layouts['models_smplx_v1_1.zip'],
        'smplxlh': layouts['smplx_lockedhead_20230207.zip'],
        'smplh': layouts['mano_v1_2.zip'],
        'smplh16': layouts['smplh.tar.xz'],
        'mano': layouts['mano_v1_2.zip'],
    }
    for model_name, member_tpl in official_member.items():
        for gender_str in (GENDER_MAPS[model_name] or {'n': ''}).values():
            member = member_tpl.format(g=gender_str)
            expected = osp.join(model_name, model_filename(model_name, _long(gender_str)))
            assert layout_for[model_name](member) == expected, (model_name, member)
