"""Stream milliseconds per fit of its rotation fits (the ``fit.rotations``
spans: the first fit's part sums, K4 in each refit, the polar), from CUDA
events."""

from portbench.stages import stream_ms_per_call


def read(t):
    return stream_ms_per_call('fit.rotations')
