"""Stream milliseconds per fit of its shape solves (the ``fit.solve``
spans: K2, K3, the kinematic prelude and the SPD solve), from CUDA events."""

from portbench.stages import stream_ms_per_call


def read(t):
    return stream_ms_per_call('fit.solve')
