"""Stream milliseconds per refiner step of its backward pass (the
``refine.backward`` span: the loss's and FK's autograd in torch ops and
K10), from CUDA events."""

from portbench.refine_spans import stream_ms_per_call


def read(t):
    return stream_ms_per_call('refine.backward')
