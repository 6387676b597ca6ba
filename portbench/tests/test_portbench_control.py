"""The control of the check, on the card (``python -m pytest -m cuda
portbench/tests``): at each cell's own size, the program's sampled rows pass
the cell's limits and the reference put in the program's place, computed in
float32 with TF32 matrix products (the precision step below the
configuration's float32), fails at least one of them."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['smpl-fit-bulk', 'smpl-forward-bulk'])
def test_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: TF32 exists only on the card')
    spec = harness.load_cell(ROOT, workload)
    ctx, program, _ = harness.prepare(spec, 'cuda')
    seed = 2 ** 31 + 101
    sets = harness.draw_inputs(spec, ctx, seed)
    results = [spec.entry.call(program, inp, spec.traffic) for inp in sets]
    samples = harness.sample_rows(spec, results, sets, seed)
    del results, sets, program
    ctx.ref32 = None
    torch.cuda.empty_cache()
    expected = harness.reference_outputs(spec, ctx, samples, torch.float64)
    log = lambda msg: None  # noqa: E731
    _, failed = harness.judge(spec, harness.compare(spec, ctx, [o for o, _ in samples], expected),
                              log)
    assert failed == 0
    rows = sum(len(o[next(iter(o))]) for o, _ in samples)
    control = harness.reference_outputs(spec, ctx, samples, torch.float32, tf32=True)
    control = [{k: torch.cat([b[k] for b in blocks]) for k in blocks[0]} for blocks in control]
    _, failed = harness.judge(spec, harness.compare(spec, ctx, control, expected), log)
    assert failed >= 1 and rows == 2 * spec.traffic['check_rows']
