"""The program's stage spans, as the per-layer readers of the stages read them.

The port records a span around each stage of its entries while the profiler
records (``smplfitter_tpu_torch.utils.profiling.span``): host nanoseconds,
stream milliseconds between CUDA events, and an empty host range at enter
and exit (the record's ``marks``) that places the span on the profiler's
clock. A program without spans gives None here, and its readers leave their
metric out.
"""

from __future__ import annotations


def records():
    """The program's finished spans (``profiling.spans()``), or None where
    the program records none or has no spans at all."""
    from smplfitter_tpu_torch.utils import profiling

    read = getattr(profiling, 'spans', None)
    return (read() or None) if read else None


def stream_ms_per_call(stage: str):
    """Stream milliseconds of the spans named ``stage``, summed, per fit
    (outermost ``fit`` span); None without such spans or times."""
    recs = records()
    if not recs:
        return None
    calls = sum(1 for r in recs if r['parent'] is None and r['name'] == 'fit')
    ms = [r['stream_ms'] for r in recs if r['name'] == stage]
    if not calls or not ms or None in ms:
        return None
    return sum(ms) / calls


def host_intervals(reading, recs, names) -> list:
    """[(start us, end us)] on the profiler's clock of the spans named in
    ``names``, from their marks among the reading's host events (a span
    whose marks the reading lacks is left out)."""
    at = {name: (s, e) for s, e, name in reading.host}
    out = []
    for r in recs:
        if r['name'] in names:
            enter, leave = (at.get(m) for m in r['marks'])
            if enter and leave:
                out.append((enter[0], leave[1]))
    return out


def idle_gaps_at(reading) -> list:
    """[(start us, length us)] of each gap between device events, walked as
    ``portbench.trace.idle_gaps`` walks them."""
    gaps, cur_e = [], None
    for _, s, e, _ in reading.events:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s - cur_e))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps
