"""Build and load the package's CUDA kernels.

``csrc/*.cu`` are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``. Nothing here runs at
import time: the first kernel launch calls :func:`library`. The library goes
to ``smplfitter_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so an unchanged tree reuses an earlier build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_ROOT = PACKAGE_DIR / '_build'
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
COMPILE_FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v', *ARCH_FLAGS]
LIB_NAME = 'libsmplfitter_kernels.so'

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types; every launcher returns a cudaError_t as int.
_SIGNATURES = {
    'lbs_points_launch': [_P] * 9 + [_I] * 7 + [_P],
    'rhs_moments_launch': [_P] * 18 + [_I] * 13 + [_P],
    'gram_terms_launch': [_P] * 14 + [_I] * 5 + [_P],
    'recon_part_sums_launch': [_P] * 16 + [_I] * 9 + [_P],
    'part_sums_launch': [_P] * 10 + [_I] * 9 + [_P],
    'recon_lbs_part_sums_launch': [_P] * 15 + [_I] * 9 + [_P],
    'posed_template_launch': [_P] * 3 + [_I] * 3 + [_P],
    'term1_launch': [_P] * 4 + [_I] * 4 + [_P],
    'term1_tiles_launch': [_P] * 3 + [_I] * 5 + [_P],
    'wgram_launch': [_P] * 19 + [_I] * 13 + [_P],
    'lbs_points_bwd_launch': [_P] * 14 + [_I] * 8 + [_P],
    'rhs_bwd_launch': [_P] * 20 + [_I] * 10 + [_P],
    'recon_bwd_launch': [_P] * 21 + [_I] * 8 + [_P],
    'recon_lbs_bwd_launch': [_P] * 22 + [_I] * 9 + [_P],
    'part_sums_bwd_launch': [_P] * 13 + [_I] * 7 + [_P],
}

_lib = None


def nvcc_path() -> str:
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and (Path(root) / 'bin' / 'nvcc').is_file():
            return str(Path(root) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')
    return found


def _source_digest(sources) -> str:
    h = hashlib.sha256(' '.join(COMPILE_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source tree has no build yet; return the
    library path. ``build.log`` beside it keeps nvcc's resource report."""
    sources = sorted(CSRC_DIR.glob('*.cu')) + sorted(CSRC_DIR.glob('*.cuh'))
    out_dir = BUILD_ROOT / _source_digest(sources)
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in sources if s.suffix == '.cu'):
        obj = out_dir / f'{src.stem}.{os.getpid()}.o'
        cmd = [nvcc, *COMPILE_FLAGS, '-I', str(CSRC_DIR), '-c', str(src), '-o', str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in jobs:
        out, err = proc.communicate()
        log.append(f'== {src.name} (exit {proc.returncode})\n{out}{err}')
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / 'build.log').write_text('\n'.join(log))
    if failed:
        raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(log))
    tmp = out_dir / f'{LIB_NAME}.{os.getpid()}.tmp'
    link = subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f'nvcc link failed:\n{link.stdout}{link.stderr}')
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    with open(out_dir / 'build.log', 'a') as f:
        f.write(f'\nbuild seconds: {time.perf_counter() - t0:.1f}\n')
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.smpl_error_string.argtypes = [_I]
        lib.smpl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().smpl_error_string(err).decode()
        raise RuntimeError(f'{kernel} launch failed: CUDA error {err} ({msg})')
