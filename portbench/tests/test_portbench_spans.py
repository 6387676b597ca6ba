"""The readers of the stage spans on hand-built span records and a
hand-built reading: stream ms per call of a stage, the rotation fits' share
of the device's idle time, the host's enqueue time, and None wherever the
program records no spans or has none at all."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import stages, trace
from smplfitter_tpu_torch.utils import profiling

METRICS = ('solve_stream_ms', 'rotfit_stream_ms', 'adjust_stream_ms', 'rotfit_idle_pct',
           'enqueue_ms')
SPEC = SimpleNamespace(per_layer=[dict(name=n, unit='x') for n in METRICS])


def _rec(index, name, parent, call, host_ms, stream_ms):
    return dict(index=index, name=name, parent=parent, call=call,
                marks=[f'{name}#{index}>', f'{name}#{index}<'], host_start_ns=0,
                host_end_ns=int(host_ms * 1e6), stream_ms=stream_ms, launches=0,
                torch_vjps=0, host_covers=0)


def _two_fits():
    """Two fits: stages (name, stream ms) each, in ordinal order."""
    recs = []
    for call, (fit_host, solve_ms) in enumerate([(100.0, 20.0), (140.0, 30.0)]):
        base = 10 * call
        recs += [_rec(base + 1, 'fit.prepare', base, base, 1, 1.0),
                 _rec(base + 2, 'fit.rotations', base, base, 5, 4.0),
                 _rec(base + 3, 'fit.solve', base, base, 9, solve_ms),
                 _rec(base + 4, 'fit.rotations', base, base, 5, 6.0),
                 _rec(base + 5, 'fit.solve', base, base, 9, solve_ms),
                 _rec(base + 6, 'fit.adjust', base, base, 3, 2.5),
                 _rec(base + 7, 'fit.outputs', base, base, 1, 0.5),
                 _rec(base, 'fit', None, base, fit_host, 90.0)]
    return recs


def _reading(host, events):
    return SimpleNamespace(calls=2, host=sorted(host), events=sorted(events, key=lambda x: x[1]))


def _marks(rec, start, end):
    return [(start, start + 1, rec['marks'][0]), (end - 1, end, rec['marks'][1])]


@pytest.fixture
def recorded(monkeypatch):
    def use(recs):
        monkeypatch.setattr(profiling, 'spans', lambda: recs)
    return use


def test_stream_ms_per_call(recorded):
    recorded(_two_fits())
    got = trace.per_layer_values(SPEC, _reading([], []))
    assert got['solve_stream_ms']['value'] == pytest.approx((2 * 20.0 + 2 * 30.0) / 2)
    assert got['rotfit_stream_ms']['value'] == pytest.approx(10.0)
    assert got['adjust_stream_ms']['value'] == pytest.approx(2.5)
    assert got['enqueue_ms']['value'] == pytest.approx(120.0)
    # No marks in the reading: the idle share has nothing to place.
    assert 'rotfit_idle_pct' not in got


def test_enqueue_ms_reads_the_outermost_spans_of_a_forward(recorded):
    recorded([_rec(0, 'forward', None, 0, 7.0, 50.0), _rec(1, 'forward', None, 1, 9.0, 50.0)])
    got = trace.per_layer_values(SPEC, _reading([], []))
    assert got == {'enqueue_ms': dict(value=pytest.approx(8.0), unit='x')}


def test_rotfit_idle_pct_counts_the_gaps_that_start_in_rotation_fits(recorded):
    recs = _two_fits()[:8]
    by_name = {}
    for r in recs:
        by_name.setdefault(r['name'], []).append(r)
    # Host: the first rotation fit over [100, 200), the solve [200, 300), the
    # refit [300, 400), the adjustment [500, 600); an operator at [700, 800).
    host = (_marks(by_name['fit.rotations'][0], 100, 200)
            + _marks(by_name['fit.solve'][0], 200, 300)
            + _marks(by_name['fit.rotations'][1], 300, 400)
            + _marks(by_name['fit.adjust'][0], 500, 600) + [(700, 800, 'aten::mul')])
    # Device: gaps start at 150 (10 us, in the first fit), 250 (20, in the
    # solve), 350 (30, in the refit; an overlapping event does not end it),
    # 550 (5, in the adjustment) and 750 (35, outside every rotation fit).
    events = [('k', 0, 150, False), ('k', 160, 250, False), ('k', 270, 340, False),
              ('k', 300, 350, True), ('k', 380, 550, False), ('k', 555, 750, False),
              ('k', 785, 900, False)]
    reading = _reading(host, events)
    assert [us for _, us in trace.idle_gaps(reading)] == [us for _, us in
                                                         stages.idle_gaps_at(reading)]
    assert stages.idle_gaps_at(reading) == [(150, 10), (250, 20), (350, 30), (550, 5), (750, 35)]
    recorded(recs)
    got = trace.per_layer_values(SPEC, reading)
    assert got['rotfit_idle_pct']['value'] == pytest.approx(100.0 * (10 + 30 + 5) / 100)


def test_rotfit_idle_pct_reads_zero_on_a_device_never_idle(recorded):
    recs = _two_fits()[:8]
    recorded(recs)
    reading = _reading(_marks(recs[1], 0, 100), [('k', 0, 50, False), ('k', 40, 90, False)])
    assert trace.per_layer_values(SPEC, reading)['rotfit_idle_pct']['value'] == 0.0


def test_no_spans_reads_nothing(recorded, monkeypatch):
    reading = _reading([(0, 10, 'aten::add')], [('k', 0, 5, False), ('k', 8, 9, False)])
    recorded([])
    assert trace.per_layer_values(SPEC, reading) == {}
    # Spans without stream times (no CUDA events): no stream metric.
    recorded([dict(r, stream_ms=None) for r in _two_fits()])
    got = trace.per_layer_values(SPEC, reading)
    assert set(got) == {'enqueue_ms'}
    # A program that predates the spans.
    monkeypatch.delattr(profiling, 'spans')
    assert trace.per_layer_values(SPEC, reading) == {}
