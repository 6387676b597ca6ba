"""K10's least time per refiner step (the ``lbs_points_bwd`` stage of
``work/refine_grad.py`` at the running cell's shapes) over the device time
per step of the kernels a K10 launch runs (``refine_spans.K10_KERNELS``),
in %; steps counted by the outermost ``refine`` spans."""

import re

from portbench import refine_spans, stages
from portbench.work import refine_grad
from portbench.yardstick import least_seconds

_K10 = re.compile('|'.join(r'\b' + name + r'\b' for name in refine_spans.K10_KERNELS))


def read(t):
    recs = stages.records()
    n = refine_spans.calls(recs) if recs else 0
    us = sum(e - s for name, s, e, _ in t.events if _K10.search(name))
    if not n or us <= 0 or not refine_spans.cell_shapes:
        return None
    least = least_seconds([st for st in refine_grad.stages(refine_spans.cell_shapes)
                           if st[0] == 'lbs_points_bwd'])
    return 100.0 * least / (us / 1e6 / n)
