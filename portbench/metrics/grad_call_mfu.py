"""The refiner step's counted f32 operations (``work/refine_grad.py``: K1
and K10) over the unprofiled window's wall seconds per call times the f32
peak, in %: ``call_mfu``'s reading, for the cells of a gradient."""

from portbench.metrics.call_mfu import read  # noqa: F401
