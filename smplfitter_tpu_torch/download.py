"""Interactive downloader for the MPI-licensed body model files, a copy of
``smplfitter_tpu.download`` (standard library only).

Usage: ``python -m smplfitter_tpu_torch.download [target_dir]``

The SMPL-family model files cannot be redistributed; each user must register at
the MPI project sites and download with their own credentials. This CLI
automates the authenticated downloads and lays the files out exactly where
:mod:`smplfitter_tpu_torch.utils.modeldata` expects them.

The official archives nest their payloads (e.g. the SMPL zip ships
``SMPL_python_v.1.1.0/smpl/models/basicmodel_*.pkl``), so extraction is
member-flattening: every archive carries a *layout rule* mapping archive member
paths to their destination inside the body_models tree, and only matching
members are written. The layout rules are pure functions, unit-tested offline
against fake archives with the official internal structure.

The JAX package's ``install_auxiliary_regressors`` (third-party SPIN and
SMPLer-X regressor files that nothing of the port reads) is left out.

Registration pages:
  https://smpl.is.tue.mpg.de/      (SMPL)
  https://smpl-x.is.tue.mpg.de/    (SMPL-X, deftrafo setups, flip corresp.)
  https://mano.is.tue.mpg.de/      (MANO / SMPL+H)
  https://agora.is.tue.mpg.de/     (kid templates)
"""

from __future__ import annotations

import argparse
import getpass
import http.cookiejar
import os
import os.path as osp
import posixpath
import shutil
import sys
import tarfile
import tempfile
import urllib.parse
import urllib.request
import zipfile
from dataclasses import dataclass
from typing import Callable, Optional

DOWNLOAD_HOST = 'https://download.is.tue.mpg.de'

REGISTRATION_URLS = {
    'smpl': 'https://smpl.is.tue.mpg.de/',
    'smplx': 'https://smpl-x.is.tue.mpg.de/',
    'mano': 'https://mano.is.tue.mpg.de/',
    'agora': 'https://agora.is.tue.mpg.de/',
}


# --------------------------------------------------------------------------
# Layout rules: archive member path -> destination relpath under body_models
# (or None to skip the member). Pure + offline-testable.
# --------------------------------------------------------------------------


def _by_basename(prefix: str, suffix: str, dest_dir: str) -> Callable[[str], Optional[str]]:
    """Rule: keep members whose basename matches prefix/suffix, flattened into
    ``dest_dir`` — ignores however deeply the official archive nests them."""

    def rule(member: str) -> Optional[str]:
        base = posixpath.basename(member)
        if base.startswith(prefix) and base.endswith(suffix):
            return posixpath.join(dest_dir, base)
        return None

    return rule


def smpl_layout(member: str) -> Optional[str]:
    """SMPL_python_v.1.1.0.zip nests ``SMPL_python_v.1.1.0/smpl/models/
    basicmodel_*_lbs_10_207_0_v1.1.0.pkl``; flatten the pkls into ``smpl/``."""
    return _by_basename('basicmodel_', '.pkl', 'smpl')(member)


def smplx_layout(member: str) -> Optional[str]:
    """models_smplx_v1_1.zip nests ``models/smplx/SMPLX_*.npz``."""
    return _by_basename('SMPLX_', '.npz', 'smplx')(member)


def smplxlh_layout(member: str) -> Optional[str]:
    """smplx_lockedhead_20230207.zip: SMPLX_*.npz into ``smplxlh/``."""
    return _by_basename('SMPLX_', '.npz', 'smplxlh')(member)


def flip_correspondences_layout(member: str) -> Optional[str]:
    """smplx_flip_correspondences.zip: the npz into ``smplx/``."""
    return _by_basename('', '.npz', 'smplx')(member)


def mano_flame_correspondences_layout(member: str) -> Optional[str]:
    """smplx_mano_flame_correspondences.zip: vertex-id pkls/npys into
    ``smplx/`` (HandReplacer reads smplx/MANO_SMPLX_vertex_ids.pkl)."""
    base = posixpath.basename(member)
    if base.endswith(('.pkl', '.npy')):
        return posixpath.join('smplx', base)
    return None


def model_transfer_layout(member: str) -> Optional[str]:
    """model_transfer.zip: the two deftrafo setup pkls go at the body_models
    root, where the converter looks for them."""
    base = posixpath.basename(member)
    if 'deftrafo_setup' in base and base.endswith('.pkl'):
        return base
    return None


def mano_package_layout(member: str) -> Optional[str]:
    """mano_v1_2.zip carries BOTH model families: ``mano_v1_2/models/
    MANO_{LEFT,RIGHT}.pkl`` -> ``mano/`` and ``SMPLH_{gender}.pkl`` ->
    ``smplh/``. One download serves both."""
    base = posixpath.basename(member)
    if base.startswith('MANO_') and base.endswith('.pkl'):
        return posixpath.join('mano', base)
    if base.startswith('SMPLH_') and base.endswith('.pkl'):
        return posixpath.join('smplh', base)
    return None


def smplh16_layout(member: str) -> Optional[str]:
    """smplh.tar.xz nests ``smplh/{male,female,neutral}/model.npz``; keep the
    gender subdirectory (the loader resolves smplh16/<gender>/model.npz)."""
    parts = posixpath.normpath(member).split('/')
    if len(parts) >= 2 and parts[-1] == 'model.npz' and parts[-2] in (
        'male', 'female', 'neutral'
    ):
        return posixpath.join('smplh16', parts[-2], 'model.npz')
    return None


# --------------------------------------------------------------------------
# Asset registry
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchiveAsset:
    """One downloadable archive + how its members map into body_models."""

    domain: str
    remote_file: str
    layout: Callable[[str], Optional[str]]
    done_markers: tuple  # relpaths whose presence means "already installed"
    symlinks: tuple = ()  # (link_relpath, target_relative_to_link_dir)


@dataclass(frozen=True)
class FileAsset:
    """One directly-saved file (no extraction)."""

    domain: str
    remote_file: str
    dest: str
    symlinks: tuple = ()


ARCHIVES = [
    ArchiveAsset(
        'smpl', 'SMPL_python_v.1.1.0.zip', smpl_layout,
        done_markers=('smpl/basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl',),
        symlinks=(
            ('smpl/SMPL_MALE.pkl', 'basicmodel_m_lbs_10_207_0_v1.1.0.pkl'),
            ('smpl/SMPL_FEMALE.pkl', 'basicmodel_f_lbs_10_207_0_v1.1.0.pkl'),
            ('smpl/SMPL_NEUTRAL.pkl', 'basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl'),
        ),
    ),
    ArchiveAsset(
        'smplx', 'models_smplx_v1_1.zip', smplx_layout,
        done_markers=('smplx/SMPLX_NEUTRAL.npz',),
    ),
    ArchiveAsset(
        'smplx', 'smplx_lockedhead_20230207.zip', smplxlh_layout,
        done_markers=('smplxlh/SMPLX_NEUTRAL.npz',),
    ),
    ArchiveAsset(
        'smplx', 'smplx_flip_correspondences.zip', flip_correspondences_layout,
        done_markers=('smplx/smplx_flip_correspondences.npz',),
    ),
    ArchiveAsset(
        'smplx', 'smplx_mano_flame_correspondences.zip',
        mano_flame_correspondences_layout,
        done_markers=('smplx/MANO_SMPLX_vertex_ids.pkl',),
    ),
    ArchiveAsset(
        'smplx', 'model_transfer.zip', model_transfer_layout,
        done_markers=(
            'smpl2smplx_deftrafo_setup.pkl', 'smplx2smpl_deftrafo_setup.pkl',
        ),
    ),
    ArchiveAsset(
        'mano', 'mano_v1_2.zip', mano_package_layout,
        done_markers=('mano/MANO_RIGHT.pkl', 'smplh/SMPLH_female.pkl'),
        symlinks=(
            ('smplh/SMPLH_FEMALE.pkl', 'SMPLH_female.pkl'),
            ('smplh/SMPLH_MALE.pkl', 'SMPLH_male.pkl'),
        ),
    ),
    ArchiveAsset(
        'mano', 'smplh.tar.xz', smplh16_layout,
        done_markers=('smplh16/female/model.npz',),
    ),
]

FILES = [
    FileAsset(
        'agora', 'smpl_kid_template.npy', 'smpl/kid_template.npy',
        symlinks=(
            ('smplh/kid_template.npy', '../smpl/kid_template.npy'),
            ('smplh16/kid_template.npy', '../smpl/kid_template.npy'),
        ),
    ),
    FileAsset(
        'agora', 'smplx_kid_template.npy', 'smplx/kid_template.npy',
        symlinks=(('smplxlh/kid_template.npy', '../smplx/kid_template.npy'),),
    ),
]


# --------------------------------------------------------------------------
# Extraction core (offline-testable)
# --------------------------------------------------------------------------


def install_archive(archive_path: str, layout, body_models_dir: str) -> list:
    """Extract the members selected by ``layout`` into ``body_models_dir``.

    Flattens each selected member to its mapped destination path (never uses
    the archive's own directory structure, and never extracts unselected
    members — no path traversal surface). Returns the installed relpaths.
    """
    installed = []
    if zipfile.is_zipfile(archive_path):
        with zipfile.ZipFile(archive_path) as zf:
            for member in zf.namelist():
                if member.endswith('/'):
                    continue
                dest_rel = layout(member)
                if dest_rel is None:
                    continue
                dest = osp.join(body_models_dir, dest_rel)
                os.makedirs(osp.dirname(dest), exist_ok=True)
                with zf.open(member) as src, open(dest, 'wb') as out:
                    shutil.copyfileobj(src, out)
                installed.append(dest_rel)
    else:
        with tarfile.open(archive_path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                dest_rel = layout(member.name)
                if dest_rel is None:
                    continue
                src = tf.extractfile(member)
                if src is None:
                    continue
                dest = osp.join(body_models_dir, dest_rel)
                os.makedirs(osp.dirname(dest), exist_ok=True)
                with src, open(dest, 'wb') as out:
                    shutil.copyfileobj(src, out)
                installed.append(dest_rel)
    return installed


def create_symlinks(symlinks, body_models_dir: str) -> None:
    """Create relative symlinks, skipping existing ones and missing targets."""
    for link_rel, target in symlinks:
        link = osp.join(body_models_dir, link_rel)
        target_abs = osp.normpath(osp.join(osp.dirname(link), target))
        if osp.lexists(link) or not osp.exists(target_abs):
            continue
        os.makedirs(osp.dirname(link), exist_ok=True)
        os.symlink(target, link)


def is_installed(asset: ArchiveAsset, body_models_dir: str) -> bool:
    return all(
        osp.exists(osp.join(body_models_dir, marker)) for marker in asset.done_markers
    )


# --------------------------------------------------------------------------
# Authenticated download
# --------------------------------------------------------------------------


def resolve_target_dir(arg_dir: Optional[str]) -> str:
    if arg_dir:
        return arg_dir
    from .utils.modeldata import resolve_body_models_dir

    return osp.abspath(resolve_body_models_dir())


def make_opener():
    jar = http.cookiejar.CookieJar()
    return urllib.request.build_opener(urllib.request.HTTPCookieProcessor(jar))


def login_and_download(opener, domain: str, remote_file: str, dest_path: str,
                       username: str, password: str) -> None:
    """Authenticated download from the MPI download host (login form POST)."""
    url = (
        f'{DOWNLOAD_HOST}/download.php?domain={domain}&resume=1'
        f'&sfile={urllib.parse.quote(remote_file)}'
    )
    data = urllib.parse.urlencode(
        dict(username=username, password=password, commit='Login')
    ).encode()
    os.makedirs(osp.dirname(dest_path) or '.', exist_ok=True)
    req = urllib.request.Request(url, data=data)
    # Download to a temp path and rename into place only on success: a failed
    # login or dropped connection must not leave a partial file that later
    # runs' existence checks treat as installed.
    tmp_path = dest_path + '.part'
    try:
        with opener.open(req) as resp, open(tmp_path, 'wb') as out:
            ctype = resp.headers.get('Content-Type', '')
            if 'text/html' in ctype:
                raise RuntimeError(
                    f'Login failed for domain {domain!r} — check credentials '
                    f'(registered at {REGISTRATION_URLS.get(domain, "?")}?)'
                )
            total = int(resp.headers.get('Content-Length', 0))
            done = 0
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
                done += len(chunk)
                if total:
                    print(
                        f'\r  {remote_file}: {done * 100 // total}%',
                        end='', flush=True,
                    )
            if total:
                print()
        os.replace(tmp_path, dest_path)
    finally:
        if osp.exists(tmp_path):
            os.remove(tmp_path)


def install_remote_archive(opener, asset: ArchiveAsset, body_models_dir: str,
                           username: str, password: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        archive_path = osp.join(tmp, osp.basename(asset.remote_file))
        print(f'  downloading {asset.remote_file} ...')
        login_and_download(
            opener, asset.domain, asset.remote_file, archive_path, username, password
        )
        installed = install_archive(archive_path, asset.layout, body_models_dir)
    print(f'  installed {len(installed)} file(s): {", ".join(installed)}')
    create_symlinks(asset.symlinks, body_models_dir)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('target_dir', nargs='?', default=None,
                        help='body_models directory (default: resolved from env)')
    parser.add_argument('--domains', nargs='*', default=list(REGISTRATION_URLS),
                        choices=list(REGISTRATION_URLS),
                        help='which MPI domains to download from')
    args = parser.parse_args(argv)

    target = resolve_target_dir(args.target_dir)
    os.makedirs(target, exist_ok=True)
    print(f'Downloading body model files into {target}')
    print('You must be registered at each project site (see --help).')

    opener = make_opener()
    credentials = {}

    def get_credentials(domain):
        if domain not in credentials:
            print(f'\n== {domain} ({REGISTRATION_URLS[domain]}) ==')
            username = input(f'  {domain} email: ').strip()
            password = getpass.getpass(f'  {domain} password: ')
            credentials[domain] = (username, password)
        return credentials[domain]

    for asset in ARCHIVES:
        if asset.domain not in args.domains:
            continue
        if is_installed(asset, target):
            print(f'[{asset.remote_file}] already installed, skipping')
            create_symlinks(asset.symlinks, target)
            continue
        username, password = get_credentials(asset.domain)
        install_remote_archive(opener, asset, target, username, password)

    for fasset in FILES:
        if fasset.domain not in args.domains:
            continue
        dest = osp.join(target, fasset.dest)
        if osp.exists(dest):
            print(f'[{fasset.remote_file}] already installed, skipping')
        else:
            username, password = get_credentials(fasset.domain)
            print(f'  downloading {fasset.remote_file} -> {fasset.dest}')
            login_and_download(
                opener, fasset.domain, fasset.remote_file, dest, username, password
            )
        create_symlinks(fasset.symlinks, target)

    print('\nDone. Set SMPLFITTER_BODY_MODELS or DATA_ROOT accordingly.')
    return 0


if __name__ == '__main__':
    sys.exit(main())
