"""Timing, device profiling and NaN checks, ported from
``smplfitter_tpu.utils.profiling``.

- :class:`Timer` and :func:`timed`: wall-clock times that wait for the
  device of their result;
- :func:`time_ms`: the median device time of a call between CUDA events;
- :func:`trace`: a scoped ``torch.profiler`` capture written as a Chrome
  trace; :func:`device_kernels` and :func:`device_launches`: the kernels a
  call runs on the device, by ``torch.profiler``;
- :func:`span`: a named stage range inside the port's entries, recorded
  only while a ``torch.profiler`` session records; :func:`spans` and
  :func:`clear_spans` read and empty the buffer of finished ones;
- :func:`debug_nans`: scoped NaN checks of the backward pass.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import statistics
import tempfile
import threading
import time
from typing import Callable, Optional

import torch

from ..ops import lbs_kernels


def _sync(result) -> None:
    """Wait for the CUDA devices that hold a tensor of ``result`` (a tensor or
    a dict, list or tuple of them)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(result)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating wall-clock timer that waits for the device of its result."""

    def __init__(self):
        self.times: list = []

    @contextlib.contextmanager
    def measure(self, result_holder: Optional[list] = None):
        """Time the enclosed block; a result put into ``result_holder`` is
        waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if result_holder:
            _sync(result_holder)
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)


def timed(fn: Callable, *args, reps: int = 5, warmup: int = 1, **kwargs):
    """Run ``fn`` ``warmup`` times, then ``reps`` times timed, each waiting for
    the device of its result: (best seconds, last result)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _sync(result)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _sync(result)
        times.append(time.perf_counter() - t0)
    return min(times), result


def time_ms(fn: Callable, arg_sets) -> float:
    """Median device time (ms, CUDA events) of ``fn`` over distinct argument
    sets, after one warm-up call on the first."""
    fn(*arg_sets[0])
    times = []
    for args in arg_sets:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn: Callable, n_calls: int = 1, cpu: bool = False) -> dict:
    """{kernel name: [device ms, launches]} summed over ``n_calls`` calls of
    ``fn`` under ``torch.profiler`` (CUDA activity; with ``cpu`` also the
    host's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    return by_name


def device_launches(fn: Callable) -> int:
    """The device kernel launches of one call of ``fn`` (torch.profiler)."""
    return sum(n for _, n in device_kernels(fn).values())


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Scoped ``torch.profiler`` capture of the host and (where there is one)
    the CUDA device, written on exit as ``trace.json`` (Chrome trace format:
    chrome://tracing or Perfetto) into ``logdir`` (default: a
    ``smplfitter_trace`` directory under the temporary directory). Yields
    ``logdir``. The spans recorded inside it (:func:`spans`) go beside it as
    ``spans.json``."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), 'smplfitter_trace')
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    t0 = time.perf_counter_ns()
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    with open(os.path.join(logdir, 'spans.json'), 'w') as f:
        json.dump([r for r in spans() if r['host_start_ns'] >= t0], f, indent=1)


# --- spans -------------------------------------------------------------------

SPAN_LIMIT = 4096  # finished spans kept; the oldest go first
_finished: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_ordinals = itertools.count()


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack = []  # this thread's entered spans, outermost first


_open = _OpenSpans()
_NOT_RECORDING = contextlib.nullcontext()


def _mark(name: str) -> None:
    """An instantaneous range on the profiler's host timeline. It launches
    nothing, so the profiler gives it no device-side annotation."""
    with torch.profiler.record_function(name):
        pass


def _counts() -> tuple:
    return tuple(sum(c.values()) for c in (lbs_kernels.LAUNCHES, lbs_kernels.TORCH_VJPS,
                                           lbs_kernels.HOST_COVERS)) + (
        lbs_kernels.K2_PIPELINE['overlapped'],)


class _Span:
    __slots__ = ('name', 'index', 'parent', 'call', 'marks', 'host_start_ns', 'host_end_ns',
                 'events', 'stream_ms', 'counts')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open.stack
        self.index = next(_ordinals)
        self.parent = stack[-1].index if stack else None
        self.call = stack[0].index if stack else self.index
        self.marks = (f'{self.name}#{self.index}>', f'{self.name}#{self.index}<')
        stack.append(self)
        _mark(self.marks[0])
        self.counts = _counts()
        self.events = None
        self.stream_ms = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.host_start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.host_end_ns = time.perf_counter_ns()
        if self.events:
            self.events[1].record()
        self.counts = tuple(b - a for a, b in zip(self.counts, _counts()))
        _mark(self.marks[1])
        _open.stack.pop()
        _finished.append(self)
        return False

    def record(self) -> dict:
        if self.events:
            self.events[1].synchronize()
            self.stream_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None
        launches, torch_vjps, host_covers, k2_overlapped = self.counts
        return dict(index=self.index, name=self.name, parent=self.parent, call=self.call,
                    marks=list(self.marks), host_start_ns=self.host_start_ns,
                    host_end_ns=self.host_end_ns, stream_ms=self.stream_ms, launches=launches,
                    torch_vjps=torch_vjps, host_covers=host_covers,
                    k2_overlapped=k2_overlapped)


def span(name: str):
    """A context manager around one stage of the port's work, which records
    only while a ``torch.profiler`` session records (``trace()``, or any
    other); otherwise it costs one check.

    A recorded span keeps, in a buffer of the last ``SPAN_LIMIT`` finished
    ones: its name, ordinal, parent span and outermost span (the call); its
    host interval (``time.perf_counter_ns``); a pair of CUDA events on the
    current stream, where CUDA is initialised, whose elapsed time is its
    stream interval, resolved when the record is read (a span never
    synchronises); the change across it of the sums of
    ``lbs_kernels.LAUNCHES``, ``TORCH_VJPS`` and ``HOST_COVERS``, and of
    ``K2_PIPELINE['overlapped']`` (K2 launches by its overlapped loop). At enter
    and exit it puts an empty range on the profiler's timeline, named
    ``<name>#<ordinal>>`` and ``<name>#<ordinal><`` (the record's
    ``marks``), which places the span among the profiler's events."""
    if not torch._C._autograd._profiler_enabled():
        return _NOT_RECORDING
    return _Span(name)


def spans() -> list:
    """The finished spans, in the order they ended, as dicts: ``index``,
    ``name``, ``parent`` and ``call`` (ordinals; ``parent`` None for an
    outermost span), ``marks``, ``host_start_ns`` / ``host_end_ns``,
    ``stream_ms`` (None without CUDA events) and the counter changes
    ``launches``, ``torch_vjps``, ``host_covers``, ``k2_overlapped``. Reading
    waits for each span's end event."""
    return [s.record() for s in list(_finished)]


def clear_spans() -> None:
    """Empty the buffer of finished spans."""
    _finished.clear()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checks: ``torch.autograd.set_detect_anomaly(enable,
    check_nan=True)``. PyTorch checks only the backward pass: a backward
    function that returns NaN raises ``RuntimeError`` naming it; NaN made in
    the forward pass goes on silently until a backward pass meets it."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield
