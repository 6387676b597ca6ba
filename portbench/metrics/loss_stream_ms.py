"""Stream milliseconds per refiner step of its forward pass and loss (the
``refine.loss`` span: FK, K1 and the distances), from CUDA events."""

from portbench.refine_spans import stream_ms_per_call


def read(t):
    return stream_ms_per_call('refine.loss')
