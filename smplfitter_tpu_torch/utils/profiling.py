"""Timing, device profiling and NaN checks, ported from
``smplfitter_tpu.utils.profiling``.

- :class:`Timer` and :func:`timed`: wall-clock times that wait for the
  device of their result;
- :func:`time_ms`: the median device time of a call between CUDA events;
- :func:`trace`: a scoped ``torch.profiler`` capture written as a Chrome
  trace; :func:`device_kernels` and :func:`device_launches`: the kernels a
  call runs on the device, by ``torch.profiler``;
- :func:`debug_nans`: scoped NaN checks of the backward pass.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import torch


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
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), 'smplfitter_trace')
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checks: ``torch.autograd.set_detect_anomaly(enable,
    check_nan=True)``. PyTorch checks only the backward pass: a backward
    function that returns NaN raises ``RuntimeError`` naming it; NaN made in
    the forward pass goes on silently until a backward pass meets it."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield
