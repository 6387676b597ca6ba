"""smplfitter_tpu_torch: SMPL-family body models in PyTorch.

The forward pass, the closed-form fit and the applications built on it:
conversion between model families (``BodyConverter``), mirroring
(``BodyFlipper``), hand grafting (``HandReplacer``) and Adam refinement
(``BodyFitterOpt``, ``BodyFlipperOpt``); batch data parallelism over
``torch.distributed`` (``parallel.sharding``), the warm-up CLI
(``precompile``), the model downloader (``download``), regressor training
for vertex subsets and profiling helpers (``utils``). A port of ``smplfitter_tpu``
(JAX/Pallas on a TPU) to PyTorch with hand-written CUDA kernels for NVIDIA
Hopper (``csrc/``). It imports no JAX.
On CPU tensors every kernel runs as its plain PyTorch twin; on CUDA tensors
the kernels are compiled with ``nvcc`` on first use.
"""

from __future__ import annotations

__version__ = '0.1.0'

from .ops.precision import get_matmul_precision, set_matmul_precision, use_true_f32

use_true_f32()

from .models.bodymodel import BodyModel  # noqa: E402
from .models.bodyfitter import BodyFitter  # noqa: E402
from .models.bodyconverter import BodyConverter  # noqa: E402
from .models.bodyflipper import BodyFlipper  # noqa: E402
from .models.bodyfitter_opt import BodyFitterOpt  # noqa: E402
from .models.bodyflipper_opt import BodyFlipperOpt  # noqa: E402
from .models.handreplacer import HandReplacer  # noqa: E402
from .api import get_cached_body_model, get_cached_fit_fn, get_fit_grad_fn  # noqa: E402

__all__ = ['BodyModel', 'BodyFitter', 'BodyConverter', 'BodyFlipper', 'BodyFitterOpt',
           'BodyFlipperOpt', 'HandReplacer', 'get_cached_body_model', 'get_cached_fit_fn',
           'get_fit_grad_fn', 'set_matmul_precision', 'get_matmul_precision', '__version__']
