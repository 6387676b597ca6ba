"""Host milliseconds per call of the entry's outermost span (``fit`` or
``forward``): how long the host takes to hand a call to the card, under the
profiler."""

from portbench import stages


def read(t):
    recs = stages.records()
    outer = [r for r in recs or () if r['parent'] is None]
    if not outer:
        return None
    return sum(r['host_end_ns'] - r['host_start_ns'] for r in outer) / len(outer) / 1e6
