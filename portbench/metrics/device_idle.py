"""The share of a call's wall time in which no operation ran on the device,
in %: the device's busy time per profiled call over the wall seconds per call
of the same run's unprofiled window (the profiler slows the host, so the
profiled calls' own wall time would read the profiler's overhead as idle)."""


def read(t):
    if t.busy_s <= 0 or t.wall_s_per_call <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.calls / t.wall_s_per_call)
