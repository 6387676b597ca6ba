"""Float32 policy of the package: the precision of the glue's matrix products.

The hand-written kernels compute in f32 on the CUDA cores whatever is set
here. The setting reaches the PyTorch ops around them (the rotation fits'
3 x 3 products, the solves' einsums, the forward kinematics).
"""

from __future__ import annotations

import torch

# The JAX package's true-f32 names. Its other names ('high', 'default') let
# the matrix units round (bf16 passes on a TPU, TF32 on this card): the port
# refuses them, see set_matmul_precision.
_TRUE_F32 = ('highest', 'float32')
_TF32 = ('high', 'default')
_PRECISION = 'highest'


def use_true_f32() -> None:
    """Run every f32 matrix product and convolution in full f32.

    TF32 keeps about three decimal digits. It is this card's form of the TPU's
    default-precision trap: the fit's moments (vertex sums over thousands of
    metre-scale terms, then a cancellation-prone elimination of the
    translation) lose the betas to it. PyTorch leaves matmuls in f32 by
    default but runs cuDNN in TF32, so both switches are set explicitly.
    """
    global _PRECISION
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    _PRECISION = 'highest'


def set_matmul_precision(precision: str) -> None:
    """Set the package-wide precision of f32 matrix products.

    ``'highest'`` and ``'float32'`` (the default at import) run full f32, as
    :func:`use_true_f32`. The JAX package's reduced names, ``'high'`` and
    ``'default'``, raise ``ValueError``: on this card they mean TF32, which
    breaks the fit's parity gate (1e-3 in betas, 0.01 mm in mean
    reconstruction error). ``chip_smoke.py`` phase 19 measures it: the B=32
    SMPL headline fit (num_iter=3) with TF32 switched on in the PyTorch ops
    around the kernels moved the betas by 1.185e-2 to 2.118e-2 and the mean
    reconstruction error by 0.0020 to 0.0111 mm from the full-f32 fit, over
    calls on different targets, on an NVIDIA H100 80GB HBM3 at a 700.00 W
    power limit. Nothing in the fit is faster for it: the kernels ignore the
    setting. Any other name raises ``ValueError`` too.
    """
    if precision in _TF32:
        raise ValueError(
            f'matmul precision {precision!r} means TF32 on the card, which moves the B=32 '
            f'headline fit\'s betas by 1.2e-2 to 2.1e-2 (parity gate 1e-3); use one of '
            f'{_TRUE_F32}')
    if precision not in _TRUE_F32:
        raise ValueError(f'unknown matmul precision {precision!r}: expected one of {_TRUE_F32}')
    global _PRECISION
    use_true_f32()
    _PRECISION = precision


def get_matmul_precision() -> str:
    """The name last given to :func:`set_matmul_precision` (``'highest'`` at import)."""
    return _PRECISION
