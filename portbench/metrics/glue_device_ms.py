"""Device milliseconds per call of the launches that are not the port's own
kernels: the glue's tensor operations, library calls, copies and sets."""


def read(t):
    us = sum(e - s for _, s, e, port in t.events if not port)
    return us / 1e3 / t.calls if t.events else None
