"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``):
the configurations' model files, written once per session into a temporary
directory, and a cell loaded with its batch cut to a size the CPU holds."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# Cells kept out of BENCHMARK.json for now (PERF.md, Open questions): their
# configuration and traffic mix, for the tests of the work counts.
HELD_CELLS = {'smplx-fit-bulk': ('smplx', 'fit-b49152'),
              'smplx-wfit-bulk': ('smplx', 'wfit-b24576')}


def any_cell(workload: str):
    """The cell ``workload``, in BENCHMARK.json or held out of it."""
    from portbench import harness

    if workload in HELD_CELLS:
        config, traffic = HELD_CELLS[workload]
        return harness.make_cell(ROOT, workload, f'portbench/configs/{config}.json', traffic)
    return harness.load_cell(ROOT, workload)


@pytest.fixture(scope='session')
def model_roots(tmp_path_factory):
    from portbench import harness, synth

    cache = str(tmp_path_factory.mktemp('models'))
    return {name: synth.ensure_model_files(
        cache, harness.read_json(os.path.join(harness.PB_DIR, 'configs', name + '.json')))
        for name in ('smpl', 'smplx')}


def small_cell(workload: str, batch: int = 8):
    """The cell ``workload`` with its batch, check and blocks cut to ``batch``
    rows, every row checked."""
    from portbench import harness

    spec = harness.load_cell(ROOT, workload)
    spec.traffic.update(batch=batch, check_rows=batch, check_block=batch, profile_calls=1)
    return spec
