"""Float32 policy of the package."""

from __future__ import annotations

import torch


def use_true_f32() -> None:
    """Run every f32 matrix product and convolution in full f32.

    TF32 keeps about three decimal digits. It is this card's form of the TPU's
    default-precision trap: the fit's moments (vertex sums over thousands of
    metre-scale terms, then a cancellation-prone elimination of the
    translation) lose the betas to it. PyTorch leaves matmuls in f32 by
    default but runs cuDNN in TF32, so both switches are set explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
