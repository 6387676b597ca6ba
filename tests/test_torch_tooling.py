"""The port's tooling on the CPU: ``BodyFitter.check_kernel_parity``, the
``precompile`` CLI, joint-regressor training for vertex subsets, the
profiling helpers and the matmul-precision switch.

On the synthetic SMPL (V=432). A fitter on the CPU has no kernels to check,
so the parity check is driven here with its card side patched to a CPU
fitter (the check then compares two CPU fits: max|d betas| = 0), and with
that side's betas moved by 1e-2 (the check must fail). The regressor keeps
the properties ``tests/test_tooling.py`` holds the JAX trainer to, at its
sizes: rows sum to 1 within 1e-5, weights >= 0, regressed joints within 0.1
of the model's on new poses; and the same seed gives the same regressor bit
for bit.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest
import torch

import smplfitter_tpu_torch
from port_on_cpu import port_model
from smplfitter_tpu_torch import precompile
from smplfitter_tpu_torch.models import bodyfitter
from smplfitter_tpu_torch.ops import _build
from smplfitter_tpu_torch.utils import joint_regressor_training as jrt
from smplfitter_tpu_torch.utils import profiling, synthetic

V = 432
PARITY_KEYS = {'ok', 'max_dbetas', 'v2v_kernel_mm', 'v2v_xla_mm'}  # the JAX package's


@pytest.fixture(scope='module')
def smpl_root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('body_models'))
    synthetic.write_model_files(d, 'smpl', V)
    return os.path.join(d, 'smpl')


@pytest.fixture(scope='module')
def smpl(smpl_root):
    return port_model('smpl', model_root=smpl_root)


# --- check_kernel_parity ----------------------------------------------------


def test_parity_check_refuses_a_cpu_fitter(smpl):
    with pytest.raises(RuntimeError, match='no kernels to check'):
        smplfitter_tpu_torch.BodyFitter(smpl).check_kernel_parity()


@pytest.fixture()
def card_side_on_cpu(monkeypatch):
    """Run the check with the CPU fitter standing in for the card's."""
    monkeypatch.setattr(bodyfitter, '_runs_kernels', lambda bm: True)


@pytest.mark.parametrize('kid', [False, True])
def test_parity_check_passes_on_equal_fits(smpl, card_side_on_cpu, kid):
    rep = smplfitter_tpu_torch.BodyFitter(smpl, enable_kid=kid).check_kernel_parity()
    assert set(rep) == PARITY_KEYS
    assert rep['ok'] is True
    assert rep['max_dbetas'] == 0.0
    assert rep['v2v_kernel_mm'] == rep['v2v_xla_mm'] and np.isfinite(rep['v2v_kernel_mm'])


@pytest.mark.parametrize('raise_on_fail', [True, False])
def test_parity_check_fails_on_moved_betas(smpl, card_side_on_cpu, monkeypatch, raise_on_fail):
    fitter = smplfitter_tpu_torch.BodyFitter(smpl)
    fit = fitter.fit

    def moved(*args, **kwargs):
        res = fit(*args, **kwargs)
        return dict(res, shape_betas=res['shape_betas'] + 1e-2)

    monkeypatch.setattr(fitter, 'fit', moved)
    if raise_on_fail:
        with pytest.raises(AssertionError, match=r'smpl .*max\|d betas\|=1\.0'):
            fitter.check_kernel_parity()
    else:
        rep = fitter.check_kernel_parity(raise_on_fail=False)
        assert rep['ok'] is False and rep['max_dbetas'] == pytest.approx(1e-2, rel=1e-3)


# --- precompile -------------------------------------------------------------


@pytest.mark.parametrize('argv, want', [
    ([], dict(model_name='smpl', gender='neutral', model_root=None,
              batch_sizes=(32, 1024, 4096), num_iter=3, num_betas=10, synthetic_fallback=False,
              grad_chunk=0, check_parity=False)),
    (['--model', 'smplx', '--gender', 'female', '--model-root', '/m', '--batch-sizes', '4', '8',
      '--num-iter', '2', '--num-betas', '16', '--synthetic', '--grad', '--check-parity'],
     dict(model_name='smplx', gender='female', model_root='/m', batch_sizes=(4, 8), num_iter=2,
          num_betas=16, synthetic_fallback=True, grad_chunk=None, check_parity=True)),
    (['--grad', '64'], dict(grad_chunk=64)),
])
def test_precompile_main_parses_every_flag(monkeypatch, argv, want):
    got = {}
    names = ('model_name', 'gender', 'model_root', 'batch_sizes', 'num_iter', 'num_betas')

    def fake_warm(*args, **kwargs):
        got.update(dict(zip(names, args)), **kwargs)

    monkeypatch.setattr(precompile, 'warm', fake_warm)
    assert precompile.main(argv) == 0
    assert {k: got[k] for k in want} == want
    assert set(got) == set(names) | {'synthetic_fallback', 'grad_chunk', 'check_parity'}


def test_precompile_warms_on_the_cpu_without_building(monkeypatch, tmp_path, capsys):
    def no_build():
        raise AssertionError('warm on the CPU built the kernels')

    monkeypatch.setattr(_build, 'library', no_build)
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path)
    written = []

    def small_models(cache_dir, full=False):
        written.append(cache_dir)
        synthetic.write_model_files(cache_dir, 'smpl', V)
        return cache_dir

    monkeypatch.setattr(synthetic, 'ensure_cached_models', small_models)
    precompile.warm(device='cpu', synthetic_fallback=True, batch_sizes=(4,), num_iter=1,
                    with_joints=False, grad_chunk=None)
    out = capsys.readouterr().out
    assert written == [str(tmp_path / 'body_models')]
    for step in ('smpl model and fitter', 'batch 4: forward and fit', 'grad batch 4'):
        assert step in out, out
    assert 'kernel library' not in out


def test_precompile_on_a_missing_card_raises(smpl_root):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        precompile.warm(model_root=smpl_root, batch_sizes=(4,))


# --- joint-regressor training ---------------------------------------------


@pytest.fixture(scope='module')
def regressor(smpl):
    subset = np.arange(0, smpl.num_vertices, 2)
    train = functools.partial(jrt.train_post_lbs_regressor, smpl, subset, num_steps=60,
                              finetune_steps=30, batch_size=16)
    return subset, train(), train


def test_regressor_rows_are_convex(smpl, regressor):
    subset, reg, _ = regressor
    assert reg.shape == (24, len(subset)) and reg.dtype == np.float32
    np.testing.assert_allclose(reg.sum(axis=1), 1.0, atol=1e-5)
    assert np.all(reg >= 0)
    assert np.count_nonzero(reg == 0) > 0  # the threshold left some weights out


def test_regressor_locates_joints(smpl, regressor):
    subset, reg, _ = regressor
    rng = np.random.default_rng(81)
    pose = rng.normal(0, 0.2, (4, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (4, 10)).astype(np.float32)
    res = smpl(pose_rotvecs=pose, shape_betas=betas)
    pred = np.einsum('jv,bvc->bjc', reg, res['vertices'].numpy()[:, subset])
    err = np.linalg.norm(pred - res['joints'].numpy(), axis=-1).mean()
    assert err < 0.1, f'regressed joint error {err}'


def test_regressor_is_seeded(regressor):
    _, reg, train = regressor
    assert np.array_equal(train(), reg)


def test_vertex_subset_assets_load(smpl, smpl_root):
    n = 64
    subset, reg = jrt.make_vertex_subset_assets(smpl, n, smpl_root, num_steps=4,
                                                finetune_steps=2, batch_size=4)
    assert subset.shape == (n,) and reg.shape == (24, n)
    sub_bm = port_model('smpl', model_root=smpl_root, vertex_subset_size=n)
    assert sub_bm.num_vertices == n
    np.testing.assert_array_equal(sub_bm.vertex_subset, subset)
    np.testing.assert_array_equal(sub_bm.model_data.J_regressor_post_lbs, reg)
    res = smpl(shape_betas=np.zeros((1, 10), np.float32))
    sub = sub_bm(shape_betas=np.zeros((1, 10), np.float32))
    np.testing.assert_allclose(sub['vertices'].numpy(), res['vertices'].numpy()[:, subset],
                               atol=1e-6)


# --- profiling ----------------------------------------------------------------


def test_timer_and_timed():
    timer = profiling.Timer()
    for _ in range(3):
        with timer.measure([torch.ones(4)]):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(timer.times) == 3 and 0 <= timer.best <= timer.mean
    calls = []
    best, result = profiling.timed(lambda x: calls.append(x) or {'y': x * 2}, torch.ones(2),
                                   reps=4, warmup=2)
    assert len(calls) == 6 and best >= 0 and torch.equal(result['y'], torch.full((2,), 2.0))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / 'trace')) as logdir:
        torch.ones(32, 32) @ torch.ones(32, 32)
    path = os.path.join(logdir, 'trace.json')
    with open(path) as f:
        assert json.load(f)['traceEvents']


def test_debug_nans_raises_on_a_backward_nan():
    x = torch.zeros(1, requires_grad=True)
    with pytest.raises(RuntimeError, match='nan'):
        with profiling.debug_nans():
            (x.sqrt() * 0).sum().backward()
    with profiling.debug_nans(False):
        (x.sqrt() * 0).sum().backward()
    assert torch.isnan(x.grad).all()


def test_benchmark_finds_every_kernel():
    """The benchmark's trace reader (``portbench.harness.kernel_patterns``)
    knows each ``__global__`` function of the kernel sources by name, so the
    device time of every kernel counts as kernel time and none as glue."""
    import re

    from portbench import harness

    csrc = _build.CSRC_DIR
    text = ''.join(p.read_text() for p in sorted(csrc.glob('*.cu*')))
    # Each kernel's name: the first identifier after __global__ that opens an
    # argument list, __launch_bounds__ aside.
    names = [m.group(1) for m in re.finditer(
        r'__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(',
        text)]
    assert len(names) == text.count('__global__') > 0
    wanted = sorted(r'\b' + n + r'\b' for n in names)
    pats = harness.kernel_patterns(str(csrc.parent.parent))
    assert sorted(p for p in pats if p in wanted) == wanted


# --- matmul precision ---------------------------------------------------------


def test_matmul_precision_defaults_to_highest():
    assert smplfitter_tpu_torch.get_matmul_precision() == 'highest'
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'


@pytest.mark.parametrize('name, tf32', [('highest', False), ('float32', False), ('high', True),
                                        ('default', True)])
def test_set_matmul_precision(name, tf32):
    """The JAX package's true-f32 names set full f32; its TF32 names raise,
    naming the measured cost, and leave the setting as it was."""
    if tf32:
        with pytest.raises(ValueError, match='TF32'):
            smplfitter_tpu_torch.set_matmul_precision(name)
        assert smplfitter_tpu_torch.get_matmul_precision() == 'highest'
    else:
        smplfitter_tpu_torch.set_matmul_precision(name)
        try:
            assert smplfitter_tpu_torch.get_matmul_precision() == name
        finally:
            smplfitter_tpu_torch.set_matmul_precision('highest')
    assert smplfitter_tpu_torch.get_matmul_precision() == 'highest'
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'


def test_unknown_matmul_precision_raises():
    with pytest.raises(ValueError, match='bfloat16'):
        smplfitter_tpu_torch.set_matmul_precision('bfloat16')
    assert smplfitter_tpu_torch.get_matmul_precision() == 'highest'
