"""A profiled stretch of calls and what the per-layer readers read from it.

``torch.profiler`` records the host's operators and the device's kernels,
copies and sets over a few calls after the measured window. The reading
keeps every device event with its name, its times and whether it is one of
the port's own kernels; the device's busy time is the union of their
intervals, and the traced window is the host clock around the calls.
"""

from __future__ import annotations

import bisect
import os
import re
import time
from types import SimpleNamespace

PB_DIR = os.path.dirname(os.path.abspath(__file__))


def profile_calls(call, n_calls: int, device, patterns) -> SimpleNamespace:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(n_calls):
            call(k)
            if torch.device(device).type == 'cuda':
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    port = re.compile('|'.join(patterns)) if patterns else None
    dev_events, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            is_port = bool(port and port.search(e.name))
            dev_events.append((e.name, start, end, is_port))
        elif e.cpu_parent is None:
            host.append((start, end, e.name))
    dev_events.sort(key=lambda x: x[1])
    host.sort()
    return SimpleNamespace(calls=n_calls, events=dev_events, host=host, window_s=window_s,
                           busy_s=busy_union_us(dev_events) / 1e6)


def busy_union_us(events) -> float:
    """Microseconds covered by at least one device event."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e, _ in events:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(reading):
    """[(host operator, gap us)] of each gap between device events, named by
    the outermost host operator running at its start ('python' for none)."""
    starts = [h[0] for h in reading.host]
    gaps, cur_e = [], None
    for _, s, e, _ in reading.events:
        if cur_e is not None and s > cur_e:
            k = bisect.bisect_right(starts, cur_e) - 1
            covered = k >= 0 and reading.host[k][1] >= cur_e
            gaps.append((reading.host[k][2] if covered else 'python', s - cur_e))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def _short(name: str) -> str:
    """A device event's name without its return type, anonymous namespace
    and argument list, at most 120 characters."""
    name = name.replace('(anonymous namespace)::', '')
    name = re.sub(r'^void ', '', name)
    return name.split('(')[0].strip()[:120]


def breakdown(reading) -> dict:
    """The 10 device operations of most time and the 10 host operators under
    which the device idled longest, in seconds over the profiled calls."""
    by_op, by_host = {}, {}
    for name, s, e, _ in reading.events:
        by_op[_short(name)] = by_op.get(_short(name), 0.0) + (e - s) / 1e6
    for name, us in idle_gaps(reading):
        by_host[_short(name)] = by_host.get(_short(name), 0.0) + us / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return dict(device_ops=top(by_op), idle_gaps=top(by_host))


def per_layer_values(spec, reading) -> dict:
    """Each per-layer metric of the cell by its reader, ``metrics/<name>.py``;
    a reader that finds nothing to read returns None and the metric is left out."""
    from portbench.harness import load_module

    out = {}
    for m in spec.per_layer:
        reader = load_module(os.path.join(PB_DIR, 'metrics', m['name'] + '.py'),
                             'pb_metric_' + re.sub(r'\W', '_', m['name']))
        value = reader.read(reading)
        if value is not None:
            out[m['name']] = dict(value=value, unit=m['unit'])
    return out
