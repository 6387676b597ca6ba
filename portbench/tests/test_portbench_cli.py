"""The command's refusals: no result without the card, none without the
program, and no JAX (or the JAX package) in the process that prints."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

from conftest import ROOT

RUN = os.path.join(ROOT, 'portbench', 'run.py')


def test_run_fails_without_a_card():
    proc = subprocess.run([sys.executable, RUN, '--workload', 'smpl-fit-bulk', '--seed',
                           str(2 ** 31 + 7), '--seconds', '1', '--trace', '0'],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ''
    assert 'CUDA device' in proc.stderr


_DRIVE = '''
import sys, time
sys.path.insert(0, {root!r})
from portbench import harness
spec = harness.load_cell({root!r}, {workload!r})
spec.traffic.update(batch=2, check_rows=2, check_block=2, profile_calls=1)
res = harness.run(spec, 3, 0.05, {trace}, 'cpu', time.perf_counter())
print('correct', res['correct'])
print('loaded', [m for m in sys.modules if m.split('.')[0] == 'smplfitter_tpu_torch'][:1])
print('forbidden', harness.forbidden_modules())
'''


def test_run_fails_without_the_program(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's files runs
    nothing: the program is not there to import."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'portbench'), tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('_models', '_cache', '_chip', '__pycache__'))
    code = _DRIVE.format(root=str(tmp_path), workload='smpl-forward-bulk', trace=False)
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert "No module named 'smplfitter_tpu_torch'" in proc.stderr
    assert 'correct' not in proc.stdout


def test_a_run_loads_no_jax():
    """A whole run (traced, so the profiler is loaded too) of the fit and the
    forward pass leaves no module whose top-level name is jax, jaxlib, flax,
    optax or smplfitter_tpu, while smplfitter_tpu_torch is loaded."""
    for workload in ('smpl-fit-bulk', 'smpl-forward-bulk'):
        code = _DRIVE.format(root=ROOT, workload=workload, trace=True)
        proc = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                              timeout=600, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "loaded ['smplfitter_tpu_torch" in proc.stdout
        assert 'forbidden []' in proc.stdout


def test_traffic_keys_that_nothing_reads_are_refused(tmp_path, monkeypatch):
    """A traffic file with a key that neither the harness nor its entry reads
    is refused, so that a knob the harness lacks never runs unread."""
    for sub in ('traffic', 'entries', 'work'):
        shutil.copytree(os.path.join(harness.PB_DIR, sub), tmp_path / sub,
                        ignore=shutil.ignore_patterns('__pycache__'))
    traffic = harness.read_json(os.path.join(harness.PB_DIR, 'traffic', 'fit-b131072.json'))
    (tmp_path / 'traffic' / 'four-callers.json').write_text(json.dumps(dict(traffic, callers=4)))
    monkeypatch.setattr(harness, 'PB_DIR', str(tmp_path))
    spec = harness.make_cell(ROOT, 'x', 'portbench/configs/smpl.json', 'fit-b131072')
    assert spec.traffic['batch'] == 131072
    with pytest.raises(SystemExit, match='callers'):
        harness.make_cell(ROOT, 'x', 'portbench/configs/smpl.json', 'four-callers')


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(['smplfitter_tpu_torch', 'smplfitter_tpu_torch.ops',
                                      'jaxtyping', 'flaxen', 'numpy']) == []
    assert harness.forbidden_modules(['smplfitter_tpu.utils', 'jax.numpy', 'optax',
                                      'jaxlib', 'flax.linen']) == [
        'flax', 'jax', 'jaxlib', 'optax', 'smplfitter_tpu']
