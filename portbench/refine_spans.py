"""The refiner step's spans and K10's kernels, as the per-layer readers of
the ``refine_grad`` entry read them.

``BodyFitterOpt.loss_and_grad`` records a ``refine`` span around
``refine.loss`` (the forward pass and the loss) and ``refine.backward`` (the
autograd call); the readers count calls by the outermost ``refine`` spans.
A program without them gives None here, and the readers leave their metric
out.
"""

from __future__ import annotations

from portbench import stages

# The kernels one K10 launch runs (csrc/lbs_points_bwd.cu), by their
# ``__global__`` names: the posed template by K7's kernel, the front, the
# ordered sum of the front's partials, and dfeat's split-K GEMM.
K10_KERNELS = ('posed_template_kernel', 'lbs_points_bwd_front', 'split_sum_kernel',
               'dfeat_gemm_kernel')

# The running cell's shapes (``harness.shapes``), recorded by
# ``entries/refine_grad.py`` when it draws the inputs: the K10 reader counts
# K10's work from them.
cell_shapes: dict = {}


def calls(recs) -> int:
    """The refiner steps among the span records: outermost ``refine`` spans."""
    return sum(1 for r in recs if r['parent'] is None and r['name'] == 'refine')


def stream_ms_per_call(stage: str):
    """Stream milliseconds of the spans named ``stage``, summed, per
    refiner step; None without such spans or times."""
    recs = stages.records()
    if not recs:
        return None
    n = calls(recs)
    ms = [r['stream_ms'] for r in recs if r['name'] == stage]
    if not n or not ms or None in ms:
        return None
    return sum(ms) / n
