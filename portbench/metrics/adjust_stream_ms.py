"""Stream milliseconds per fit of its final adjustment (the ``fit.adjust``
span: K4 and a polar per tree level), from CUDA events."""

from portbench.stages import stream_ms_per_call


def read(t):
    return stream_ms_per_call('fit.adjust')
