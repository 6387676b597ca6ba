"""Device milliseconds per call of the port's own kernels."""


def read(t):
    us = sum(e - s for _, s, e, port in t.events if port)
    return us / 1e3 / t.calls if us > 0 else None
