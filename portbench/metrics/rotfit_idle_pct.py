"""The share of the profiled calls' device idle time, in %, whose gaps start
while the host is inside a rotation fit (``fit.rotations``) or the final
adjustment (``fit.adjust``): the gaps between device events as
``portbench.trace.idle_gaps`` finds them, placed among the spans by the
spans' marks on the profiler's clock."""

from portbench import stages


def read(t):
    recs = stages.records()
    if not recs:
        return None
    spans = stages.host_intervals(t, recs, ('fit.rotations', 'fit.adjust'))
    if not spans:
        return None
    gaps = stages.idle_gaps_at(t)
    total = sum(us for _, us in gaps)
    if total <= 0:
        return 0.0
    inside = sum(us for s, us in gaps if any(a <= s <= b for a, b in spans))
    return 100.0 * inside / total
